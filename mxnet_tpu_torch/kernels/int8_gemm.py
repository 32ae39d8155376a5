"""int8 GEMM with the dequantize, bias and relu epilogue: the hand-written
CUDA kernel for Hopper and its plain PyTorch version (registry family
``int8_gemm``).

Replaces the TPU kernel ``mxnet_tpu/kernels/int8_gemm.py:_gemm_body``
(K4, launched by ``_kernel``'s ``pallas_call`` :86). Contract, as there::

    int8_gemm(qx int8 (M, K), weight int8 (N, K), scale_eff f32 scalar,
              (1,) or (N,), bias=None or f32 (N,), relu=False) -> f32 (M, N)
    out = relu?(float(qx @ weight.T) * scale_eff + bias)

with exact int32 accumulation and the float32 epilogue in that order.
``scale_eff`` is the folded activation x weight scale (``s_x * scale`` of
the quantized FullyConnected, ``ops/quantization.py``).

The plain version is the JAX package's ``_xla`` baseline in PyTorch: the
product in float64 is exact (``|acc| <= 127 * 127 * K < 2**53``), so
``.to(int32)`` gives the int32 sum, then the same epilogue. It runs for
CPU tensors (the tests) and is what ``chip_smoke.py`` holds the kernel to
on the card; the card's main path never calls it.

Contract of the kernel against the plain version: bit-exact (the kernel
rounds int32 -> float32 to nearest even and uses correctly rounded
multiply and add in the same order; ``csrc/int8_gemm.cu``). The kernel's
design and what bounds it are described in that source.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["int8_gemm", "int8_gemm_plain"]

_fn = []


def _launcher():
    if not _fn:
        fn = build.library("int8_gemm").mxtt_int8_gemm
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def int8_gemm_plain(qx, weight, scale_eff, bias=None, relu=False):
    """The same function in plain PyTorch (any device)."""
    acc = (qx.double() @ weight.double().t()).to(torch.int32)
    out = acc.to(torch.float32) * scale_eff
    if bias is not None:
        out = out + bias
    if relu:
        out = out.clamp_min(0.0)
    return out


def _check(qx, weight, scale_eff, bias):
    dev = qx.device
    if qx.ndim != 2 or weight.ndim != 2 or qx.shape[1] != weight.shape[1]:
        raise ValueError(f"int8_gemm: expects qx (M, K) and weight (N, K), "
                         f"got {tuple(qx.shape)} and {tuple(weight.shape)}")
    n = weight.shape[0]
    named = [("qx", qx, torch.int8), ("weight", weight, torch.int8),
             ("scale_eff", scale_eff, torch.float32)]
    if bias is not None:
        named.append(("bias", bias, torch.float32))
    for name, t, dtype in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"int8_gemm: {name} is on {t.device}; all "
                             f"tensors must be on one CUDA card ({dev})")
        if t.dtype != dtype:
            raise ValueError(f"int8_gemm: {name} is {t.dtype}, the kernel "
                             f"takes {dtype}")
    if scale_eff.numel() not in (1, n):
        raise ValueError(f"int8_gemm: scale_eff has {scale_eff.numel()} "
                         f"elements; expected 1 or {n}")
    if bias is not None and bias.numel() != n:
        raise ValueError(f"int8_gemm: bias has {bias.numel()} elements; "
                         f"expected {n}")
    if max(qx.shape[0], n, qx.shape[1]) >= 2 ** 31:
        raise ValueError(f"int8_gemm: dims {tuple(qx.shape)} x {n} exceed "
                         "the kernel's int range")


def int8_gemm(qx, weight, scale_eff, bias=None, relu=False):
    """One launch of ``csrc/int8_gemm.cu`` on the current stream; CUDA
    tensors only."""
    _check(qx, weight, scale_eff, bias)
    m, k = qx.shape
    n = weight.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=qx.device)
    if m == 0 or n == 0:
        return out
    qx, weight = qx.contiguous(), weight.contiguous()
    scale = scale_eff.reshape(-1).contiguous()
    bias = None if bias is None else bias.reshape(-1).contiguous()
    with torch.cuda.device(qx.device):
        rc = _launcher()(
            qx.data_ptr(), weight.data_ptr(), scale.data_ptr(),
            0 if scale.numel() == 1 else 1,
            None if bias is None else bias.data_ptr(), int(bool(relu)),
            out.data_ptr(), m, n, k,
            torch.cuda.current_stream(qx.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_gemm: kernel launch failed with CUDA error "
                           f"{rc} at M={m} N={n} K={k}")
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def _register():
    from . import register_kernel

    register_kernel(
        "int8_gemm", kernel=int8_gemm, plain=int8_gemm_plain,
        replaces="mxnet_tpu/kernels/int8_gemm.py:86 (_kernel, body "
                 "_gemm_body)",
        tolerance="bit-exact vs the plain version (exact int32 "
                  "accumulation; int32->float32 to nearest even, then "
                  "scale, bias, relu, each correctly rounded)")


_register()
