"""Fused multi-tensor optimizer steps: hand-written CUDA kernels for Hopper
and their plain PyTorch versions (registry families ``opt_sgd`` and
``opt_adam``).

Replace the TPU kernels ``mxnet_tpu/kernels/opt_step.py:_sgd_mom_body``
(K1, ``_kernel_sgd``) and ``_adam_body`` (K2, ``_kernel_adam``), which
``_run`` launches once per parameter. Here one call updates a whole list
of parameters IN PLACE (weights and state; the JAX package donates the
same buffers), with one launch of ``csrc/opt_step.cu``:

* ``opt_sgd(weights, grads, moms, lr, wds, momentum=..., ...)``:
  ``g = clip(rescale*grad)``, ``m' = momentum*m - lr*(g + wd*w)``,
  ``w' = w + m'``;
* ``opt_adam(weights, grads, means, vars, lr, wds, beta1=..., ...)``:
  ``g = clip(rescale*grad + wd*w)``, ``mean' = b1*mean + (1-b1)*g``,
  ``var' = b2*var + (1-b2)*g*g``, ``w' = w - lr*mean'/(sqrt(var')+eps)``
  (the caller folds Adam's bias correction into ``lr``).

``lr`` is a float32 device scalar and ``wds`` a per-tensor list of weight
decays; ``skip``, an optional float32 device scalar, makes the call a
no-op when non-zero (the trainer's non-finite guard) without a host sync.

The device table (pointers, sizes, chunk starts and weight decay per
tensor, 56 bytes each, copied from pinned memory without a host sync) is
rebuilt only when one of those changes: gradients come fresh from
``torch.autograd.grad`` every step, but the caching allocator usually
returns the same addresses, so at steady state the first step's table is
reused. Building it costs more host time than the kernel takes on the
card (measured: a multi-tensor Adam step over BERT-base's 197 tensors
took 3.0 ms when rebuilt every call, 1.3 ms reused). What bounds the
kernel: memory (Adam reads w, g,
mean, var and writes w, mean, var: 28 bytes per parameter; SGD 20), so
0.91 ms for the 109 M parameters of BERT-base at 3.35 TB/s.

Contract: bit-exact against the plain versions for float32 (the kernel
uses correctly rounded intrinsics in the op order of
``ops/optimizer_op.py``); only float32 tensors are taken.
"""
from __future__ import annotations

import ctypes

import numpy as _np
import torch

from ..ops import optimizer_op as _op
from . import build

__all__ = ["opt_sgd", "opt_adam", "opt_sgd_plain", "opt_adam_plain",
           "CHUNK"]

CHUNK = 16384  # elements per chunk, as kChunk in csrc/opt_step.cu
# one 56-byte row per tensor, the layout of TensorDesc in csrc/opt_step.cu
_TABLE_DTYPE = _np.dtype([("w", "<u8"), ("g", "<u8"), ("s0", "<u8"),
                          ("s1", "<u8"), ("n", "<i8"),
                          ("chunk_begin", "<i8"), ("wd", "<f4"),
                          ("pad", "<i4")])
assert _TABLE_DTYPE.itemsize == 56
_fns = {}
_tables = {}   # family -> (key, device table, n_tensors, n_chunks)


def _launcher(symbol, n_floats):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.library("opt_step"), symbol)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p] + \
            [ctypes.c_float] * n_floats + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


# ---- plain versions (CPU tensors; comparisons on the card) ---------------

def _skipped(skip):
    return skip is not None and bool(skip)


def opt_sgd_plain(weights, grads, moms, lr, wds, *, momentum, rescale_grad=1.0,
                  clip_gradient=-1.0, skip=None):
    """SGD-momentum over lists, in place, through ``sgd_mom_update``."""
    if _skipped(skip):
        return
    with torch.no_grad():
        for w, g, m, wd in zip(weights, grads, moms, wds):
            w2, m2 = _op.sgd_mom_update(
                w, g, m, lr=lr, momentum=momentum, wd=wd,
                rescale_grad=rescale_grad, clip_gradient=clip_gradient)
            w.copy_(w2)
            m.copy_(m2)


def opt_adam_plain(weights, grads, means, variances, lr, wds, *, beta1=0.9,
                   beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                   clip_gradient=-1.0, skip=None):
    """Adam over lists, in place, through ``adam_update``."""
    if _skipped(skip):
        return
    with torch.no_grad():
        for w, g, m, v, wd in zip(weights, grads, means, variances, wds):
            w2, m2, v2 = _op.adam_update(
                w, g, m, v, lr=lr, beta1=beta1, beta2=beta2,
                epsilon=epsilon, wd=wd, rescale_grad=rescale_grad,
                clip_gradient=clip_gradient)
            w.copy_(w2)
            m.copy_(m2)
            v.copy_(v2)


# ---- CUDA wrappers -------------------------------------------------------

def _check(family, lists, lr, skip):
    w0 = lists[0][0] if lists[0] else None
    if w0 is None or any(len(x) != len(lists[0]) for x in lists):
        raise ValueError(f"{family}: empty or unequal tensor lists")
    dev = w0.device
    for t in [lr] + ([skip] if skip is not None else []):
        if t.device != dev or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"{family}: lr and skip must be float32 scalars "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    for i, group in enumerate(zip(*lists)):
        w = group[0]
        for t in group:
            if t.device.type != "cuda" or t.device != dev:
                raise ValueError(f"{family}: tensor {i} is on {t.device}; all "
                                 f"tensors must be on one CUDA card ({dev})")
            if t.dtype != torch.float32:
                raise ValueError(f"{family}: tensor {i} is {t.dtype}; the "
                                 "kernel takes float32 only")
            if t.shape != w.shape:
                raise ValueError(f"{family}: tensor {i} shapes "
                                 f"{[tuple(x.shape) for x in group]} differ")
        for t in (group[0],) + group[2:]:
            if not t.is_contiguous():
                raise ValueError(f"{family}: tensor {i} is updated in place "
                                 "and must be contiguous")


def _table(family, weights, grads, s0, s1, wds):
    """``(device table, n_tensors, n_chunks)`` of the non-empty tensors,
    rebuilt when a pointer, size or weight decay changed since the
    family's last call."""
    rows = [(w.data_ptr(), g.data_ptr(), a.data_ptr(),
             b.data_ptr() if b is not None else 0, w.numel(), float(wd))
            for w, g, a, b, wd in zip(weights, grads, s0, s1, wds)
            if w.numel() > 0]
    key = (weights[0].device, tuple(rows))
    cached = _tables.get(family)
    if cached is not None and cached[0] == key:
        return cached[1:]
    arr = _np.zeros(len(rows), _TABLE_DTYPE)
    begin = 0
    for i, (w, g, a, b, n, wd) in enumerate(rows):
        arr[i] = (w, g, a, b, n, begin, wd, 0)
        begin += -(-n // CHUNK)
    host = torch.from_numpy(arr.view(_np.uint8)).pin_memory()
    table = host.to(weights[0].device, non_blocking=True)
    _tables[family] = (key, table, len(rows), begin)
    return table, len(rows), begin


def _launch(family, symbol, floats, weights, grads, s0, s1, lr, wds, skip):
    """Launch over the non-empty tensors; False when there are none."""
    grads = [g.contiguous() for g in grads]  # alive until the launch
    table, n_tensors, n_chunks = _table(family, weights, grads, s0, s1,
                                        wds)
    if n_tensors == 0:
        return False
    w0 = weights[0]
    with torch.cuda.device(w0.device):
        rc = _launcher(symbol, len(floats))(
            table.data_ptr(), n_tensors, n_chunks, lr.data_ptr(),
            skip.data_ptr() if skip is not None else None, *floats,
            torch.cuda.current_stream(w0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{family}: kernel launch failed with CUDA error "
                           f"{rc} over {n_tensors} tensors")
    return True


def opt_sgd(weights, grads, moms, lr, wds, *, momentum, rescale_grad=1.0,
            clip_gradient=-1.0, skip=None):
    """One launch of the SGD-momentum kernel over every tensor, in place."""
    _check("opt_sgd", [weights, grads, moms], lr, skip)
    if _launch("opt_sgd", "mxtt_opt_sgd_mom",
               (momentum, rescale_grad, clip_gradient), weights, grads, moms,
               [None] * len(moms), lr, wds, skip):
        opt_sgd.launches += 1


def opt_adam(weights, grads, means, variances, lr, wds, *, beta1=0.9,
             beta2=0.999, epsilon=1e-8, rescale_grad=1.0, clip_gradient=-1.0,
             skip=None):
    """One launch of the Adam kernel over every tensor, in place. The
    constants ``1 - beta`` are computed in double and rounded once to
    float32, as PyTorch rounds the Python scalars of the plain version."""
    _check("opt_adam", [weights, grads, means, variances], lr, skip)
    if _launch("opt_adam", "mxtt_opt_adam",
               (beta1, 1 - beta1, beta2, 1 - beta2, epsilon, rescale_grad,
                clip_gradient), weights, grads, means, variances, lr, wds,
               skip):
        opt_adam.launches += 1


opt_sgd.launches = 0
opt_adam.launches = 0


def _register():
    from . import register_kernel

    tol = ("bit-exact vs ops/optimizer_op.py for float32 (correctly rounded "
           "intrinsics in the same op order)")
    register_kernel("opt_sgd", kernel=opt_sgd, plain=opt_sgd_plain,
                    replaces="mxnet_tpu/kernels/opt_step.py:_kernel_sgd",
                    tolerance=tol)
    register_kernel("opt_adam", kernel=opt_adam, plain=opt_adam_plain,
                    replaces="mxnet_tpu/kernels/opt_step.py:_kernel_adam",
                    tolerance=tol)


_register()
