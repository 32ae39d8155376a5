"""Flash attention: hand-written CUDA kernels for Hopper, their plain
PyTorch versions, and the autograd function that joins them (registry
families ``flash_attention``, ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv``).

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

Backward (``csrc/flash_attention_bwd.cu``) replaces the JAX package's
``_flash_backward``, a blocked recompute in plain JAX with O(S*block)
memory. The forward also writes each row's log-sum-exp when asked; two
deterministic kernels then recompute probabilities from q, k and it:
``dq`` (one block per q tile, which also writes ``D = rowsum(dO*o)``)
and ``dkv`` (one block per k tile), no atomics, same domain as the
forward. At the training shape (B=32, H=12, S=128, D=64, float32) the
pair does 14*B*H*S*S*D = 5.6 GFLOP against 10*B*H*S*S*D = 4.0 GFLOP for
the whole backward done once (dq, dk, dv and one recompute of P), so
float32 FMAs bound it (60 us at 67 TFLOP/s) before its 8 x 12.6 MB of
traffic (30 us).

:func:`flash_attention` is the differentiable entry point. When a graph
is being recorded it runs :class:`FlashAttentionFunction`, whose forward
saves q, k, v, o and the log-sum-exp and whose backward calls the two
backward families; each family dispatches by device (kernel on a card,
plain version on the CPU). Without grad it calls the forward alone, as
serving does.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["flash_attention", "FlashAttentionFunction",
           "flash_attention_plain", "flash_backward_plain", "flash_forward",
           "flash_backward_dq", "flash_backward_dkv"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def _masked_scores(q, k, scale, causal, dtype=None):
    """``scale * q k^T`` in ``dtype`` (default q's), -inf above the
    top-left diagonal when causal."""
    if dtype is not None:
        q, k = q.to(dtype), k.to(dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        qlen, klen = s.shape[-2], s.shape[-1]
        mask = torch.ones((qlen, klen), dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    return s


def flash_attention_plain(q, k, v, scale, causal, with_lse=False):
    """Dense attention, as ``flash_attention_reference`` in the JAX
    package: scores in q's dtype, softmax in float32, probabilities cast
    back to q's dtype before the product with v. ``with_lse`` also
    returns each row's float32 log-sum-exp of the scores."""
    s = _masked_scores(q, k, scale, causal).float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return (out, torch.logsumexp(s, dim=-1)) if with_lse else out


def _probs_and_ds(q, k, v, do, dsum, scale, causal):
    """Float32 dense recompute: probabilities P and dS = P (dO v^T - D)."""
    f32 = torch.float32
    p = torch.softmax(_masked_scores(q, k, scale, causal, f32), dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(f32), v.to(f32))
    return p, p * (dp - dsum.unsqueeze(-1))


def flash_backward_dq_plain(q, k, v, o, lse, do, scale, causal):
    """Plain version of the dq kernel: ``(dq, D)`` with ``D =
    rowsum(dO o)`` in float32 (``lse`` is not needed by the dense
    recompute)."""
    dsum = (do.float() * o.float()).sum(-1)
    _, ds = _probs_and_ds(q, k, v, do, dsum, scale, causal)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return dq.to(q.dtype), dsum


def flash_backward_dkv_plain(q, k, v, lse, dsum, do, scale, causal):
    """Plain version of the dkv kernel: ``(dk, dv)``."""
    p, ds = _probs_and_ds(q, k, v, do, dsum, scale, causal)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_plain(q, k, v, o, do, scale, causal):
    """Gradients ``(dq, dk, dv)`` of attention by a dense recompute in
    float32, cast to the input dtype: the plain counterpart of the JAX
    package's ``_flash_backward`` and of the two backward kernels."""
    dq, dsum = flash_backward_dq_plain(q, k, v, o, None, do, scale, causal)
    dk, dv = flash_backward_dkv_plain(q, k, v, None, dsum, do, scale,
                                      causal)
    return dq, dk, dv


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "mxtt_flash_attention_forward": ("flash_attention",
                                     [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P]),
    "mxtt_flash_attention_bwd_dq": ("flash_attention_bwd",
                                    [_P] * 8 + [_I] * 4 + [_F, _I, _I, _P]),
    "mxtt_flash_attention_bwd_dkv": ("flash_attention_bwd",
                                     [_P] * 8 + [_I] * 4 + [_F, _I, _I, _P]),
}


def _launcher(symbol):
    fn = _fns.get(symbol)
    if fn is None:
        lib, argtypes = _SIGNATURES[symbol]
        fn = getattr(build.library(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check(q, k, v, **more):
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
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
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d or \
            any(t.shape != q.shape for t in more.values()):
        raise ValueError(f"flash_forward: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"{[tuple(t.shape) for t in more.values()]} do not "
                         "match")
    if d % 8 or not 0 < d <= 512:
        raise ValueError(f"flash_forward: head dim {d} outside the "
                         "kernel's domain (a multiple of 8 up to 512)")
    if min(b, h, sq, k.shape[2]) < 1:
        raise ValueError(f"flash_forward: empty input {tuple(q.shape)}")


def _dense(t):
    """Contiguous and 16-byte aligned, as the kernel's vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _raise_on(rc, what, q):
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc} for q{tuple(q.shape)} {q.dtype}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_forward(q, k, v, scale, causal=False, with_lse=False):
    """Launch the forward kernel on CUDA tensors (B, H, S, D) on the
    current stream; returns the output, and with ``with_lse`` also its
    (B, H, Sq) float32 log-sum-exp. Raises on anything outside the
    kernel's domain and on a failed launch."""
    _check(q, k, v)
    q, k, v = _dense(q), _dense(k), _dense(v)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    with torch.cuda.device(q.device):
        rc = _launcher("mxtt_flash_attention_forward")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b * h, sq, k.shape[2], d,
            float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
            _stream(q))
    _raise_on(rc, "flash_forward", q)
    flash_forward.launches += 1
    return (out, lse) if with_lse else out


def _check_lse(q, *stats):
    for t in stats:
        if t.dtype != torch.float32 or t.shape != q.shape[:3] or \
                t.device != q.device:
            raise ValueError(f"flash backward: row statistics must be "
                             f"float32 {tuple(q.shape[:3])} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def flash_backward_dq(q, k, v, o, lse, do, scale, causal=False):
    """Launch the dq kernel: returns ``(dq, D)``, ``D = rowsum(dO o)``
    float32 (B, H, Sq), which :func:`flash_backward_dkv` needs."""
    _check(q, k, v, o=o, do=do)
    _check_lse(q, lse)
    q, k, v, o, do, lse = (_dense(t) for t in (q, k, v, o, do, lse))
    b, h, sq, d = q.shape
    dq = torch.empty_like(q)
    dsum = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        rc = _launcher("mxtt_flash_attention_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dsum.data_ptr(),
            b * h, sq, k.shape[2], d, float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype], _stream(q))
    _raise_on(rc, "flash_backward_dq", q)
    flash_backward_dq.launches += 1
    return dq, dsum


def flash_backward_dkv(q, k, v, lse, dsum, do, scale, causal=False):
    """Launch the dkv kernel after :func:`flash_backward_dq` on the same
    stream: returns ``(dk, dv)``."""
    _check(q, k, v, do=do)
    _check_lse(q, lse, dsum)
    q, k, v, do, lse, dsum = (_dense(t) for t in (q, k, v, do, lse, dsum))
    b, h, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = _launcher("mxtt_flash_attention_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b * h, sq, k.shape[2], d, float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype], _stream(q))
    _raise_on(rc, "flash_backward_dkv", q)
    flash_backward_dkv.launches += 1
    return dk, dv


flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Attention whose forward and backward go through the kernel
    families (the JAX package's ``_flash`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        from . import dispatch

        # saved dense, so the backward kernels copy none of them again
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = dispatch("flash_attention", q, k, v, scale, causal,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        from . import dispatch

        q, k, v, out, lse = ctx.saved_tensors
        dq, dsum = dispatch("flash_attention_bwd_dq", q, k, v, out, lse, do,
                            ctx.scale, ctx.causal)
        dk, dv = dispatch("flash_attention_bwd_dkv", q, k, v, lse, dsum, do,
                          ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale, causal=False):
    """Differentiable attention over (B, H, S, D) tensors: through
    :class:`FlashAttentionFunction` when grad mode is on and an input
    requires grad, else the forward family alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, float(scale),
                                            bool(causal))
    from . import dispatch

    return dispatch("flash_attention", q, k, v, float(scale),
                    causal=bool(causal))


def _register():
    from . import register_kernel

    register_kernel(
        "flash_attention", kernel=flash_forward, plain=flash_attention_plain,
        replaces="mxnet_tpu/kernels/flash.py:_flash_kernel",
        tolerance="f32 rtol=atol=2e-5, bf16 rtol=atol=2e-2 vs the plain "
                  "version (softmax normaliser reassociated across k tiles; "
                  "bf16: the plain version rounds scores and "
                  "probabilities to bf16, the kernel keeps float32)")
    bwd_tol = ("f32 rtol=atol=2e-5, bf16 rtol=atol=2e-2 vs the dense "
               "float32 recompute (sums reassociated across tiles; "
               "probabilities from the saved log-sum-exp)")
    register_kernel(
        "flash_attention_bwd_dq", kernel=flash_backward_dq,
        plain=flash_backward_dq_plain,
        replaces="mxnet_tpu/kernels/flash.py:_flash_backward",
        tolerance=bwd_tol)
    register_kernel(
        "flash_attention_bwd_dkv", kernel=flash_backward_dkv,
        plain=flash_backward_dkv_plain,
        replaces="mxnet_tpu/kernels/flash.py:_flash_backward",
        tolerance=bwd_tol)


_register()
