"""Flash attention forward: a hand-written CUDA kernel for Hopper and its
plain PyTorch version (registry family ``flash_attention``).

Replaces the TPU kernel ``mxnet_tpu/kernels/flash.py:_flash_kernel``
(launched by ``flash_forward`` there). Same contract: for q ``(B, H,
Sq, D)`` and k, v ``(B, H, Sk, D)``, ``out[b,h,i] = sum_j softmax_j(scale
* q_i . k_j, masked) v_j``, accumulated in float32 with an online softmax
(running max and normaliser, final divide by ``max(l, 1e-30)``), output
in q's dtype; the causal mask is aligned top-left (``q_pos >= k_pos``),
as ``tril`` on ``(Sq, Sk)`` in the JAX reference; ``Sq != Sk`` is
allowed; float32 and bfloat16 inputs; any ``S >= 1`` (the kernel masks
the ragged last tile itself); ``D`` a multiple of 8 up to 512.

What bounds it on the card: at the serving shape (B=32, H=12, S=128,
D=64, float32) one call does 4*B*H*S*S*D = 1.61 GFLOP on 50.3 MB of
q/k/v/o, so float32 arithmetic outside the tensor cores (67 TFLOP/s,
24 us) bounds it before memory (3.35 TB/s, 15 us). The design
(``csrc/flash_attention.cu``) keeps the (S, S) score matrix out of
device memory: one block per (b*h, q tile) loads its q tile once and
streams k/v tiles through shared memory, so device traffic is one read
of q, k, v and one write of o; scores and the accumulator live in
registers, and the float32 products are register-blocked (4 q rows x 8
columns per thread) so shared-memory reads do not bound the FMA rate.
Causal tiles wholly above the diagonal are skipped. Tensor cores
(``wgmma``), TMA and warp specialisation are later work.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["flash_attention_plain", "flash_forward"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def flash_attention_plain(q, k, v, scale, causal):
    """Dense attention, as ``flash_attention_reference`` in the JAX
    package: scores in q's dtype, softmax in float32, probabilities cast
    back to q's dtype before the product with v."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        qlen, klen = s.shape[-2], s.shape[-1]
        mask = torch.ones((qlen, klen), dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("flash_attention").mxtt_flash_attention_forward
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_forward: {name} is on {t.device}; all "
                             "of q, k, v must be on one CUDA card")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_forward: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
        if t.ndim != 4:
            raise ValueError(f"flash_forward: {name} has rank {t.ndim}; "
                             "expected (B, H, S, D)")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_forward: dtype {q.dtype} not supported "
                         "(float32, bfloat16)")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"flash_forward: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} do not match")
    if d % 8 or not 0 < d <= 512:
        raise ValueError(f"flash_forward: head dim {d} outside the "
                         "kernel's domain (a multiple of 8 up to 512)")
    if min(b, h, sq, k.shape[2]) < 1:
        raise ValueError(f"flash_forward: empty input {tuple(q.shape)}")


def _dense(t):
    """Contiguous and 16-byte aligned, as the kernel's vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_forward(q, k, v, scale, causal=False):
    """Launch the CUDA kernel on CUDA tensors (B, H, S, D) on the current
    stream; returns a new tensor. Raises on anything outside the
    kernel's domain and on a failed launch."""
    _check(q, k, v)
    q, k, v = _dense(q), _dense(k), _dense(v)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), b * h, sq, k.shape[2], d,
                         float(scale), int(bool(causal)),
                         _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_forward: kernel launch failed with CUDA "
                           f"error {rc} for q{tuple(q.shape)} {q.dtype}")
    flash_forward.launches += 1
    return out


flash_forward.launches = 0


def _register():
    from . import register_kernel

    register_kernel(
        "flash_attention", kernel=flash_forward, plain=flash_attention_plain,
        replaces="mxnet_tpu/kernels/flash.py:_flash_kernel",
        tolerance="f32 rtol=atol=2e-5, bf16 rtol=atol=2e-2 vs the plain "
                  "version (softmax normaliser reassociated across k tiles; "
                  "bf16: the plain version rounds scores and "
                  "probabilities to bf16, the kernel keeps float32)")


_register()
