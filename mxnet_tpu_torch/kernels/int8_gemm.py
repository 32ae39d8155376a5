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

from . import build, count

__all__ = ["int8_gemm", "int8_gemm_plain", "tile_config"]

_lib_cache = []


def _lib():
    if not _lib_cache:
        lib = build.library("int8_gemm")
        ptr, i = ctypes.c_void_p, ctypes.c_int
        gemm = [ptr, ptr, ptr, i, ptr, i, ptr, i, i, i]
        for name, args in (("mxtt_int8_gemm", gemm + [ptr]),
                           ("mxtt_int8_gemm_tile",
                            gemm + [i, ptr, ctypes.POINTER(i)]),
                           ("mxtt_int8_gemm_pick_tile", [i, i]),
                           ("mxtt_int8_gemm_blocks_per_sm", [i])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib_cache.append(lib)
    return _lib_cache[0]


def tile_config(m, n, tile_n=0):
    """The kernel's output tile width for an (m, n) output (``tile_n``
    when given, else the kernel's own choice) and how many of its blocks
    fit on one SM at once (the CUDA occupancy calculator, cp.async path).
    Needs the card."""
    lib = _lib()
    tile_n = tile_n or lib.mxtt_int8_gemm_pick_tile(m, n)
    return {"tile": [128, tile_n],
            "blocks_per_sm": lib.mxtt_int8_gemm_blocks_per_sm(tile_n)}


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
    # get_device() is the card's index (-1 on the CPU), read without
    # building a torch.device: this runs 74 times per served int8 batch
    index = qx.get_device()
    if qx.ndim != 2 or weight.ndim != 2 or qx.shape[1] != weight.shape[1]:
        raise ValueError(f"int8_gemm: expects qx (M, K) and weight (N, K), "
                         f"got {tuple(qx.shape)} and {tuple(weight.shape)}")
    n = weight.shape[0]
    for name, t, dtype in (("qx", qx, torch.int8),
                           ("weight", weight, torch.int8),
                           ("scale_eff", scale_eff, torch.float32),
                           ("bias", bias, torch.float32)):
        if t is None:
            continue
        if index < 0 or t.get_device() != index:
            raise ValueError(f"int8_gemm: {name} is on {t.device}; all "
                             f"tensors must be on one CUDA card "
                             f"({qx.device})")
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
    return index


def int8_gemm(qx, weight, scale_eff, bias=None, relu=False, tile_n=0):
    """One launch of ``csrc/int8_gemm.cu`` on the current stream; CUDA
    tensors only. ``tile_n`` (64 or 128) forces the output tile's width,
    for timing the two against each other; the port leaves it 0, the
    kernel's own choice. Counts the launch in ``int8_gemm.launches`` and,
    by the path the launch reports, in ``int8_gemm.launches_by_path``:
    "async" (cp.async copies into the pipeline: K a multiple of 16 and
    both operands 16-byte aligned) or "staged" (byte loads through
    registers).

    The served int8 encoder calls this 74 times a batch, and at its
    shapes the host's part of a call takes about as long as the kernel:
    so the wrapper makes one foreign call, reads the raw stream handle,
    and takes a device guard only when the operands are not on the
    current card."""
    index = _check(qx, weight, scale_eff, bias)
    m, k = qx.shape
    n = weight.shape[0]
    out = qx.new_empty((m, n), dtype=torch.float32)
    if m == 0 or n == 0:
        return out
    # a contiguous scale of 1 or n elements, and bias of n, are read flat
    qx, weight, scale = qx.contiguous(), weight.contiguous(), \
        scale_eff.contiguous()
    lib = _lib()
    path = ctypes.c_int(-1)
    args = (qx.data_ptr(), weight.data_ptr(), scale.data_ptr(),
            0 if scale.numel() == 1 else 1,
            None if bias is None else bias.contiguous().data_ptr(),
            int(bool(relu)), out.data_ptr(), m, n, k, tile_n)
    if index == torch.cuda.current_device():
        rc = lib.mxtt_int8_gemm_tile(
            *args, torch._C._cuda_getCurrentRawStream(index),
            ctypes.byref(path))
    else:
        with torch.cuda.device(index):
            rc = lib.mxtt_int8_gemm_tile(
                *args, torch._C._cuda_getCurrentRawStream(index),
                ctypes.byref(path))
    if rc != 0:
        raise RuntimeError(f"int8_gemm: kernel launch failed with CUDA error "
                           f"{rc} at M={m} N={n} K={k}")
    count(int8_gemm)
    count(int8_gemm, "launches_by_path",
          "async" if path.value == 1 else "staged")
    return out


int8_gemm.launches = 0
int8_gemm.launches_by_path = {"async": 0, "staged": 0}


def _flops(qx, weight, scale_eff, bias=None, relu=False, tile_n=0):
    """K4: 2·M·N·K integer operations (the int8 products and their int32
    sums; the float epilogue is not counted)."""
    return 2 * qx.shape[0] * weight.shape[0] * qx.shape[1], "int"


def _register():
    from . import register_kernel

    register_kernel(
        "int8_gemm", kernel=int8_gemm, plain=int8_gemm_plain, flops=_flops,
        replaces="mxnet_tpu/kernels/int8_gemm.py:86 (_kernel, body "
                 "_gemm_body)",
        tolerance="bit-exact vs the plain version (exact int32 "
                  "accumulation; int32->float32 to nearest even, then "
                  "scale, bias, relu, each correctly rounded)")


_register()
