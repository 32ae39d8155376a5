"""KV-cache decode attention: a hand-written CUDA kernel for Hopper and its
plain PyTorch version (registry family ``decode_attention``).

Replaces the TPU kernel ``mxnet_tpu/kernels/decode_attention.py:_kernel``
(body ``_decode_body``). Same contract: ``(q (B, H, D), k and v (B, H, S,
D), lengths int32 (B,), scale) -> (B, H, D)`` in q's dtype, where the
keys at positions ``>= lengths[b]`` of row b are masked out; each length
must be at least 1 (a row with no key has no attention distribution; the
plain version gives NaN there, like the JAX reference). float32 and
bfloat16 inputs, ``D`` a multiple of 8 up to 512, any ``S >= 1``.

What bounds it on the card: every valid key is read once (k and v) and
used for ``2 * D`` multiply-adds, so device memory, counted over the
filled cache only: ``sum(lengths) * H * D * 2 * dtype bytes``. The design
(``csrc/decode_attention.cu``) gives each (b, h) one block of four warps
that reads only the first ``lengths[b]`` keys, four keys per warp and
step, with an online softmax per warp and a merge of the four through
shared memory; padded cache rows are never read.

Contract: f32 rtol = atol = 2e-5, bf16 2e-2 against the plain version
(the normaliser is reassociated across warps and steps; for bf16 the
plain version rounds scores and probabilities to bf16, the kernel keeps
float32).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, count

__all__ = ["decode_attention", "decode_attention_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def decode_attention_plain(q, k, v, lengths, scale):
    """Dense masked single-query attention, as
    ``mxnet_tpu/kernels/decode_attention.py:decode_attention_reference``:
    scores in q's dtype, softmax in float32, probabilities cast back to
    q's dtype before the product with v."""
    s = torch.einsum("bhd,bhkd->bhk", q, k) * scale
    pos = torch.arange(k.shape[2], device=q.device)
    mask = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhk,bhkd->bhd", p, v)


def _launcher():
    fn = _fns.get("decode")
    if fn is None:
        fn = build.library("decode_attention").mxtt_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["decode"] = fn
    return fn


def _check(q, k, v, lengths):
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {t.device}; "
                             "all inputs must be on one CUDA card")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"decode_attention: dtypes q {q.dtype}, k "
                         f"{k.dtype}, v {v.dtype}; the kernel takes float32 "
                         "or bfloat16, all alike")
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}; expected q "
                         "(B, H, D) and k, v (B, H, S, D)")
    b, h, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or k.shape[2] < 1:
        raise ValueError(f"decode_attention: q{tuple(q.shape)} does not "
                         f"match the cache {tuple(k.shape)}")
    if d % 8 or not 0 < d <= 512:
        raise ValueError(f"decode_attention: head dim {d} outside the "
                         "kernel's domain (a multiple of 8 up to 512)")
    if lengths.shape != (b,):
        raise ValueError(f"decode_attention: lengths {tuple(lengths.shape)}"
                         f", expected ({b},)")


def decode_attention(q, k, v, lengths, scale):
    """Launch the decode kernel on CUDA tensors on the current stream;
    returns the (B, H, D) output. Raises on anything outside the kernel's
    domain and on a failed launch."""
    _check(q, k, v, lengths)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    b, h, d = q.shape
    out = torch.empty_like(q)
    if b * h == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b * h, h, k.shape[2], d, float(scale),
            _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed with "
                           f"CUDA error {rc} for q{tuple(q.shape)} "
                           f"k{tuple(k.shape)} {q.dtype}")
    count(decode_attention)
    return out


decode_attention.launches = 0


def _flops(q, k, v, lengths, scale):
    """K5, elementwise over the cache: 4·B·H·S·D (a multiply and an add
    for each of q·k and p·v, per cached key). The lengths live on the
    device, so the count takes the whole cache, not the valid keys."""
    b, h, s, d = k.shape
    return 4 * b * h * s * d, "float"


def _register():
    from . import register_kernel

    register_kernel(
        "decode_attention", kernel=decode_attention,
        plain=decode_attention_plain, flops=_flops,
        replaces="mxnet_tpu/kernels/decode_attention.py:_kernel",
        tolerance="f32 rtol=atol=2e-5, bf16 rtol=atol=2e-2 vs the plain "
                  "version (normaliser reassociated across warps; bf16: "
                  "the plain version rounds scores and probabilities to "
                  "bf16, the kernel keeps float32)")


_register()
