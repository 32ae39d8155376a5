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
q/k/v/o. The kernel (``csrc/flash_attention.cu``) runs its products on
the tensor cores (``mma.sync`` m16n8k8 TF32), made float32-accurate by
the 3xTF32 split (three TF32 products, 4.83 GFLOP, 9.8 us at 495
TFLOP/s), so bytes bound it (15.0 us at 3.35 TB/s). It keeps the (S, S)
scores in registers, so device traffic is one read of q, k, v and one
write of o, and it reads q, k, v and writes o through their (B, H, S)
strides: the (B, S, H, D) activations of a MultiHeadAttention reach it
as transposed views and are not copied, and the output is allocated in
(B, S, H, D) order and returned as its (B, H, S, D) view, so the
caller's transpose back is a view too. k and v tiles arrive by
``cp.async`` with the next tile in flight. Head dims above 128 take a
second kernel of the family (float32 FMAs on the CUDA cores); the path
follows from D alone, and each launch reports it
(``flash_forward.launches_by_path``). ``wgmma``, TMA and warp
specialisation are later work.

Backward (``csrc/flash_attention_bwd.cu``) replaces the JAX package's
``_flash_backward``, a blocked recompute in plain JAX with O(S*block)
memory. The forward also writes each row's log-sum-exp when asked; two
deterministic kernels then recompute probabilities from q, k and it, no
atomics, same domain as the forward: ``dq`` (one block per 64 q rows,
which also writes ``D = rowsum(dO*o)``), then ``dkv`` (one block per 64
keys). Up to D = 128 both run every product on the tensor cores as the
forward does (3xTF32 ``mma.sync``; QK-shaped S and dP, PV-shaped dS k,
P^T dO and dS^T q with the accumulator relabelled as the A operand),
stream their tiles by ``cp.async`` and read q, k, v, o and dO through
their (B, H, S) strides; dq, dk and dv are allocated in their input's
memory order and written through their strides, so the transposed
(B, S, H, D) views of a MultiHeadAttention and the gradients that flow
back to them are copied neither way. Head dims above 128 take a SIMT
kernel of each family; each launch reports its path
(``flash_backward_dq.launches_by_path``,
``flash_backward_dkv.launches_by_path``) and an input the kernels cannot
read in place is copied and counted (``.copies``). At the training shape
(B=32, H=12, S=128, D=64, float32) dq does 3 and dkv 4 products of
2*B*H*S*S*D = 0.81 GFLOP, as three TF32 products 14.6 and 19.5 us at 495
TFLOP/s, while each kernel moves six 12.6 MB tensors plus lse and D,
22.7 us at 3.35 TB/s: bytes bound both.

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

from . import build, count

__all__ = ["flash_attention", "FlashAttentionFunction",
           "flash_attention_plain", "flash_backward_plain", "flash_forward",
           "flash_backward_dq", "flash_backward_dkv", "forward_blocks_per_sm",
           "backward_blocks_per_sm"]

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


_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
_SIGNATURES = {
    "mxtt_flash_attention_forward": (
        "flash_attention", [_P] * 5 + [_I] * 5 + [_L] * 12
        + [_F, _I, _I, _P, ctypes.POINTER(_I)]),
    "mxtt_flash_attention_blocks_per_sm": ("flash_attention", [_I, _I]),
    "mxtt_flash_attention_bwd_dq": (
        "flash_attention_bwd", [_P] * 8 + [_I] * 5 + [_L] * 18
        + [_F, _I, _I, _P, ctypes.POINTER(_I)]),
    "mxtt_flash_attention_bwd_dkv": (
        "flash_attention_bwd", [_P] * 8 + [_I] * 5 + [_L] * 18
        + [_F, _I, _I, _P, ctypes.POINTER(_I)]),
    "mxtt_flash_attention_bwd_blocks_per_sm": ("flash_attention_bwd",
                                               [_I, _I, _I]),
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


def _check(what, q, k, v, **more):
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}; all of q, "
                             "k, v must be on one CUDA card")
        if t.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, q is {q.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{what}: {name} has rank {t.ndim}; expected "
                             "(B, H, S, D)")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: dtype {q.dtype} not supported "
                         "(float32, bfloat16)")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d or \
            any(t.shape != q.shape for t in more.values()):
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"{[tuple(t.shape) for t in more.values()]} do not "
                         "match")
    if d % 8 or not 0 < d <= 512:
        raise ValueError(f"{what}: head dim {d} outside the kernel's domain "
                         "(a multiple of 8 up to 512)")
    if min(b, h, sq, k.shape[2]) < 1:
        raise ValueError(f"{what}: empty input {tuple(q.shape)}")


def _dense(t):
    """Contiguous and 16-byte aligned, as the kernel's vector loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _raise_on(rc, what, q):
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{rc} for q{tuple(q.shape)} {q.dtype}")


def _readable(t):
    """Whether the kernels read ``t`` (B, H, S, D) in place: D
    stride 1 and every row starting on 16 bytes (the pointer and each
    stride of a dim longer than 1)."""
    st, size = t.stride(), t.element_size()
    return st[3] == 1 and t.data_ptr() % 16 == 0 and all(
        n == 1 or (s * size) % 16 == 0 for s, n in zip(st[:3], t.shape[:3]))


def _operands(fn, *ts):
    """``ts`` as the kernels read them: in place where :func:`_readable`,
    else a dense 16-byte aligned copy, counted in ``fn.copies``."""
    out = []
    for t in ts:
        if not _readable(t):
            count(fn, "copies")
            t = _dense(t)
        out.append(t)
    return out


def _call(symbol, what, q, args):
    """One foreign call of a launch function on the current stream of q's
    card (a device guard only off the current card); returns the path the
    launch reports, "mma" (tensor cores) or "simt"."""
    path = ctypes.c_int(-1)
    index = q.get_device()
    launch = _launcher(symbol)
    if index == torch.cuda.current_device():
        rc = launch(*args, torch._C._cuda_getCurrentRawStream(index),
                    ctypes.byref(path))
    else:
        with torch.cuda.device(index):
            rc = launch(*args, torch._C._cuda_getCurrentRawStream(index),
                        ctypes.byref(path))
    _raise_on(rc, what, q)
    return "mma" if path.value == 1 else "simt"


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def flash_forward(q, k, v, scale, causal=False, with_lse=False):
    """Launch the forward kernel on CUDA tensors (B, H, S, D) on the
    current stream; returns the output, and with ``with_lse`` also its
    (B, H, Sq) float32 log-sum-exp. Raises on anything outside the
    kernel's domain and on a failed launch.

    q, k and v are read through their strides (transposed views of
    (B, S, H, D) activations included); one is copied only where the
    kernel cannot read it (a D stride other than 1, or a row that does
    not start on 16 bytes), counted in ``flash_forward.copies``. The
    output is allocated in (B, S, H, D) memory order and returned as its
    ``permute(0, 2, 1, 3)`` view, of shape (B, H, Sq, D). Each launch
    counts in ``flash_forward.launches`` and, by the path it reports, in
    ``flash_forward.launches_by_path`` ("mma": the tensor-core kernel, D
    <= 128; "simt": D above)."""
    _check("flash_forward", q, k, v)
    q, k, v = _operands(flash_forward, q, k, v)
    b, h, sq, d = q.shape
    out = q.new_empty((b, sq, h, d)).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, h, sq, k.shape[2], d,
            *_strides(q, k, v, out), float(scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype])
    path = _call("mxtt_flash_attention_forward", "flash_forward", q, args)
    count(flash_forward)
    count(flash_forward, "launches_by_path", path)
    return (out, lse) if with_lse else out


def forward_blocks_per_sm(d, dtype=torch.float32):
    """Blocks of the forward kernel that head dim ``d`` takes that fit on
    one SM at once (the CUDA occupancy calculator). Needs the card."""
    return _launcher("mxtt_flash_attention_blocks_per_sm")(
        d, _DTYPE_CODES[dtype])


def backward_blocks_per_sm(d, dtype=torch.float32):
    """``{"dq": n, "dkv": n}``: blocks of each backward kernel that head
    dim ``d`` takes that fit on one SM at once. Needs the card."""
    fn = _launcher("mxtt_flash_attention_bwd_blocks_per_sm")
    return {"dq": fn(0, d, _DTYPE_CODES[dtype]),
            "dkv": fn(1, d, _DTYPE_CODES[dtype])}


def _check_lse(q, *stats):
    for t in stats:
        if t.dtype != torch.float32 or t.shape != q.shape[:3] or \
                t.device != q.device:
            raise ValueError(f"flash backward: row statistics must be "
                             f"float32 {tuple(q.shape[:3])} on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def flash_backward_dq(q, k, v, o, lse, do, scale, causal=False):
    """Launch the dq kernel: returns ``(dq, D)``, ``D = rowsum(dO o)``
    float32 (B, H, Sq), which :func:`flash_backward_dkv` needs.

    q, k, v, o and dO are read through their strides, as
    :func:`flash_forward` reads its inputs (a copy only where the kernel
    cannot, counted in ``flash_backward_dq.copies``); lse is dense. dq is
    allocated in q's memory order and written through its strides. Each
    launch counts in ``launches`` and ``launches_by_path`` as the
    forward's do."""
    _check("flash_backward_dq", q, k, v, o=o, do=do)
    _check_lse(q, lse)
    q, k, v, o, do = _operands(flash_backward_dq, q, k, v, o, do)
    lse = lse.contiguous()
    b, h, sq, d = q.shape
    # empty_like keeps the strides of a dense permutation (a transposed
    # (B, S, H, D) view stays one, so the caller's transpose back is a
    # view) and makes anything else contiguous; rows start on 16 bytes
    dq = torch.empty_like(q)
    dsum = torch.empty_like(lse)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dsum.data_ptr(),
            b, h, sq, k.shape[2], d, *_strides(q, k, v, o, do, dq),
            float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype])
    path = _call("mxtt_flash_attention_bwd_dq", "flash_backward_dq", q, args)
    count(flash_backward_dq)
    count(flash_backward_dq, "launches_by_path", path)
    return dq, dsum


def flash_backward_dkv(q, k, v, lse, dsum, do, scale, causal=False):
    """Launch the dkv kernel after :func:`flash_backward_dq` on the same
    stream: returns ``(dk, dv)``, in k's and v's memory order; inputs as
    for :func:`flash_backward_dq` (copies in
    ``flash_backward_dkv.copies``)."""
    _check("flash_backward_dkv", q, k, v, do=do)
    _check_lse(q, lse, dsum)
    q, k, v, do = _operands(flash_backward_dkv, q, k, v, do)
    lse, dsum = lse.contiguous(), dsum.contiguous()
    b, h, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)  # as dq
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, sq, k.shape[2], d, *_strides(q, k, v, do, dk, dv),
            float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype])
    path = _call("mxtt_flash_attention_bwd_dkv", "flash_backward_dkv", q,
                 args)
    count(flash_backward_dkv)
    count(flash_backward_dkv, "launches_by_path", path)
    return dk, dv


for _fn in (flash_forward, flash_backward_dq, flash_backward_dkv):
    _fn.launches = 0
    _fn.launches_by_path = {"mma": 0, "simt": 0}
    _fn.copies = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Attention whose forward and backward go through the kernel
    families (the JAX package's ``_flash`` custom_vjp). Each launch goes
    to the current stream of q's card: in a backward, the stream that
    autograd's engine runs it on, which is the forward's (inside a
    captured training step or pair, the capture stream, so K3-bwd is part
    of the backward graph and its saved tensors live in the graph's
    pool). The wrappers keep no table or scratch buffer between calls."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        from . import dispatch

        # q, k and v are saved as they come (a MultiHeadAttention's
        # transposed (B, S, H, D) views) and the output is a (B, H, S, D)
        # view of (B, S, H, D) memory: the kernels read them, and dO,
        # through their strides and write the gradients in their inputs'
        # memory order, so neither direction copies
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
