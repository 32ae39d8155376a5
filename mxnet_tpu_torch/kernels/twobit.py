"""2-bit gradient compression: hand-written CUDA kernels for Hopper and
their plain PyTorch versions (registry families ``twobit_compress`` and
``twobit_decompress``).

Replace the TPU kernels ``mxnet_tpu/kernels/twobit.py:_kernel_compress``
(K6, body ``_compress_body``) and ``_kernel_decompress`` (K7, body
``_decompress_body``), which the dist kvstore runs once per parameter on
every push (compress) and on every resolved reduction (decompress):

* ``twobit_compress(grad, residual, thr) -> (codes int8, new_residual)``:
  ``g = grad + residual``; codes ``+1`` where ``g >= thr``, ``-1`` where
  ``g <= -thr``, else ``0``; ``new_residual = g - codes * thr``;
* ``twobit_decompress(codes, thr, dtype=float32) -> codes * thr`` in
  ``dtype``, for int8 codes or the int8/int32 sum of several workers'
  codes.

What bounds them on the card: each is one elementwise pass, so device
memory (compress moves 13 bytes per element, decompress 5 from int8
codes); ``csrc/twobit.cu`` is one grid-stride loop with 16-byte accesses
where the pointers allow. Contract: bit-exact against the plain versions
and the JAX package's ``_xla_compress`` / ``_xla_decompress``, for
float32 gradients; the threshold is rounded once to float32 in both.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import canonical_dtype
from . import build

__all__ = ["twobit_compress", "twobit_decompress", "twobit_compress_plain",
           "twobit_decompress_plain"]

_CODE_BYTES = {torch.int8: 1, torch.int32: 4}
_fns = {}


def _thr32(thr, device):
    """The threshold as the float32 scalar both versions compare with."""
    return torch.tensor(float(thr), dtype=torch.float32, device=device)


# ---- plain versions (CPU tensors; comparisons on the card) ---------------

def twobit_compress_plain(grad, residual, thr):
    """``(codes int8, new_residual)``, in the op order of
    ``mxnet_tpu/kernels/twobit.py:_xla_compress``."""
    t = _thr32(thr, grad.device)
    g = grad + residual
    one = torch.ones((), dtype=torch.int8, device=grad.device)
    zero = torch.zeros((), dtype=torch.int8, device=grad.device)
    codes = torch.where(g >= t, one, torch.where(g <= -t, -one, zero))
    return codes, g - codes.to(g.dtype) * t


def twobit_decompress_plain(codes, thr, dtype=torch.float32):
    """``codes.astype(dtype) * thr``."""
    dtype = canonical_dtype(dtype)
    return codes.to(dtype) * _thr32(thr, codes.device).to(dtype)


# ---- CUDA wrappers -------------------------------------------------------

def _launcher(symbol, argtypes):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.library("twobit"), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _aligned(tensors_and_bytes):
    return all(t.data_ptr() % b == 0 for t, b in tensors_and_bytes)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def twobit_compress(grad, residual, thr):
    """Launch the compress kernel on CUDA float32 tensors of one shape;
    returns new ``(codes int8, new_residual)`` tensors."""
    if grad.device.type != "cuda" or residual.device != grad.device:
        raise ValueError(f"twobit_compress: grad on {grad.device} and "
                         f"residual on {residual.device}; both must be on "
                         "one CUDA card")
    if grad.dtype != torch.float32 or residual.dtype != torch.float32:
        raise ValueError(f"twobit_compress: grad {grad.dtype} and residual "
                         f"{residual.dtype}; the kernel takes float32")
    if grad.shape != residual.shape:
        raise ValueError(f"twobit_compress: grad {tuple(grad.shape)} and "
                         f"residual {tuple(residual.shape)} differ")
    grad, residual = grad.contiguous(), residual.contiguous()
    codes = torch.empty(grad.shape, dtype=torch.int8, device=grad.device)
    new_res = torch.empty_like(grad)
    n = grad.numel()
    if n == 0:
        return codes, new_res
    vec = _aligned(((grad, 16), (residual, 16), (new_res, 16), (codes, 4)))
    with torch.cuda.device(grad.device):
        rc = _launcher("mxtt_twobit_compress", [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p])(
            grad.data_ptr(), residual.data_ptr(), codes.data_ptr(),
            new_res.data_ptr(), n, float(thr), int(vec), _stream(grad))
    if rc != 0:
        raise RuntimeError(f"twobit_compress: kernel launch failed with CUDA "
                           f"error {rc} for {n} elements")
    twobit_compress.launches += 1
    return codes, new_res


def twobit_decompress(codes, thr, dtype=torch.float32):
    """Launch the decompress kernel on CUDA int8 or int32 codes; returns
    a new float32 tensor of their shape."""
    if codes.device.type != "cuda":
        raise ValueError(f"twobit_decompress: codes on {codes.device}; the "
                         "kernel takes a CUDA tensor")
    if codes.dtype not in _CODE_BYTES:
        raise ValueError(f"twobit_decompress: codes are {codes.dtype}; the "
                         "kernel takes int8 or int32")
    if canonical_dtype(dtype) != torch.float32:
        raise ValueError(f"twobit_decompress: output dtype {dtype}; the "
                         "kernel writes float32")
    codes = codes.contiguous()
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    n = codes.numel()
    if n == 0:
        return out
    nbytes = _CODE_BYTES[codes.dtype]
    vec = _aligned(((codes, 4 * nbytes), (out, 16)))
    with torch.cuda.device(codes.device):
        rc = _launcher("mxtt_twobit_decompress", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p])(
            codes.data_ptr(), nbytes, out.data_ptr(), n, float(thr),
            int(vec), _stream(codes))
    if rc != 0:
        raise RuntimeError(f"twobit_decompress: kernel launch failed with "
                           f"CUDA error {rc} for {n} elements")
    twobit_decompress.launches += 1
    return out


twobit_compress.launches = 0
twobit_decompress.launches = 0


def _register():
    from . import register_kernel

    register_kernel(
        "twobit_compress", kernel=twobit_compress,
        plain=twobit_compress_plain,
        replaces="mxnet_tpu/kernels/twobit.py:_kernel_compress",
        tolerance="bit-exact vs the plain version and _xla_compress "
                  "(correctly rounded add, multiply and subtract)")
    register_kernel(
        "twobit_decompress", kernel=twobit_decompress,
        plain=twobit_decompress_plain,
        replaces="mxnet_tpu/kernels/twobit.py:_kernel_decompress",
        tolerance="bit-exact (one correctly rounded float32 multiply)")


_register()
