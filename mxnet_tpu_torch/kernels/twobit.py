"""2-bit gradient compression: hand-written CUDA kernels for Hopper and
their plain PyTorch versions (registry families ``twobit_compress``,
``twobit_decompress`` and ``twobit_compress_multi``).

Replace the TPU kernels ``mxnet_tpu/kernels/twobit.py:_kernel_compress``
(K6, body ``_compress_body``) and ``_kernel_decompress`` (K7, body
``_decompress_body``), which the JAX package's dist kvstore runs once per
parameter on every push (compress) and on every resolved reduction
(decompress):

* ``twobit_compress(grad, residual, thr) -> (codes int8, new_residual)``:
  ``g = grad + residual``; codes ``+1`` where ``g >= thr``, ``-1`` where
  ``g <= -thr``, else ``0``; ``new_residual = g - codes * thr``;
* ``twobit_decompress(codes, thr, dtype=float32) -> codes * thr`` in
  ``dtype``, for int8 codes or the int8/int32 sum of several workers'
  codes; on the dist kvstore's bucketed path one launch covers a
  contiguous run of reduced wire slices;
* ``twobit_compress_multi(grads, residuals, codes, thr)``: the compress
  of every listed gradient in ONE launch, IN PLACE: each gradient's codes
  into its ``codes`` slot and its new residual into its ``residuals``
  slot (the dist kvstore's flat wire and residual buffers,
  ``kvstore/buckets.py:FlatLayout``).

What bounds them on the card: each is one elementwise pass, so device
memory (compress moves 13 bytes per element, decompress 5 from int8
codes). The multi-tensor compress and the int8 decompress move 16
elements a thread, 512 a warp, with every access coalesced, in tiles of
4096 dealt round-robin to one wave of blocks (``csrc/twobit.cu`` says
how); the single-tensor compress (the per-key path) and the int32
decompress are one grid-stride loop, four elements a thread. The multi-tensor
compress's host part is built once per key set: :func:`plan` turns the
tensors' pointers and sizes into the device table (one 48-byte row per
tensor) and the row each tile starts in; the tables of the last few key
sets are cached by a fingerprint of every tensor (pointer, size, dtype,
device, contiguity), so a call whose fingerprint was seen (at steady
state the caching allocator returns the same gradient addresses) skips
the checks and the upload, with ``opt_step``'s table and cache.

Dtypes: the multi-tensor compress takes float32; the single-tensor
compress also float16 and bfloat16 gradients, and the decompress writes
any of the three (the JAX store compresses a half-precision key through
XLA and scales its codes back in the key's dtype).

Contract: bit-exact against the plain versions and the JAX package's
``_xla_compress`` / ``_xla_decompress`` / ``_kernel_decompress``. The
threshold is rounded to float32 and from there to the gradient's (or
output's) dtype, as the JAX store's XLA path rounds a weak-typed Python
float (:func:`round_threshold`); each ``+``, ``-`` and ``*`` is rounded to
that dtype.
"""
from __future__ import annotations

import collections
import ctypes
import itertools
import operator

import numpy as _np
import torch

from ..base import canonical_dtype
from . import DeviceError, build, count
from .opt_step import _Table, _Tables

__all__ = ["twobit_compress", "twobit_decompress", "twobit_compress_plain",
           "twobit_decompress_plain", "twobit_compress_multi",
           "twobit_compress_multi_plain", "plan", "Plan", "round_threshold"]

_CODE_BYTES = {torch.int8: 1, torch.int32: 4}
# the kernels' dtype codes (csrc/twobit.cu)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# one 48-byte row per tensor, the layout of CompressRow in csrc/twobit.cu
_ROW_DTYPE = _np.dtype([("grad", "<u8"), ("res", "<u8"), ("codes", "<u8"),
                        ("n", "<i8"), ("begin", "<i8"), ("vec", "<i4"),
                        ("pad", "<i4")])
assert _ROW_DTYPE.itemsize == 48
GROUP = 512         # elements a warp handles per tile, kWarpElems
TILE_GROUPS = 8     # groups per tile, kTileGroups in csrc/twobit.cu
_DEVICE_TYPE = "cuda"  # the device the kernels take

_PTR = torch.Tensor.data_ptr
_NUMEL = torch.Tensor.numel
_CONTIG = torch.Tensor.is_contiguous
_DEVICE_INDEX = torch.Tensor.get_device   # an int: cheaper than .device
_DTYPE = operator.attrgetter("dtype")

_fns = {}
_waves = {}    # (which, device index) -> blocks of one full wave


def round_threshold(thr, dtype):
    """``thr`` as the JAX package's store uses it in ``dtype`` (float32,
    float16 or bfloat16): with 64-bit mode off, JAX makes the weak-typed
    Python float a float32 first and rounds that to the gradient's dtype
    (``_xla_compress``, ``_xla_decompress``; a float16 tie of the two
    roundings, such as ``1 + 2**-11 + 2**-40``, goes to 1.0 there). Exact
    in float32."""
    return torch.tensor(float(thr), dtype=torch.float32).to(dtype).item()


def _thr(thr, dtype, device):
    """The threshold as the scalar of ``dtype`` both versions use."""
    return torch.tensor(round_threshold(thr, dtype), dtype=dtype,
                        device=device)


# ---- plain versions (CPU tensors; comparisons on the card) ---------------

def twobit_compress_plain(grad, residual, thr):
    """``(codes int8, new_residual)``, in the op order of
    ``mxnet_tpu/kernels/twobit.py:_xla_compress``, in the gradient's
    dtype."""
    t = _thr(thr, grad.dtype, grad.device)
    g = grad + residual
    one = torch.ones((), dtype=torch.int8, device=grad.device)
    zero = torch.zeros((), dtype=torch.int8, device=grad.device)
    codes = torch.where(g >= t, one, torch.where(g <= -t, -one, zero))
    return codes, g - codes.to(g.dtype) * t


def twobit_decompress_plain(codes, thr, dtype=torch.float32):
    """``codes.astype(dtype) * thr``."""
    dtype = canonical_dtype(dtype)
    return codes.to(dtype) * _thr(thr, dtype, codes.device)


def twobit_compress_multi_plain(grads, residuals, codes, thr):
    """The per-tensor plain compress of each gradient, written into its
    residual and code slots in place (the multi-tensor kernel's
    contract)."""
    for g, r, c in zip(grads, residuals, codes):
        new_codes, new_res = twobit_compress_plain(g.reshape(-1),
                                                   r.reshape(-1), thr)
        r.copy_(new_res.view(r.shape))
        c.copy_(new_codes.view(c.shape))


# ---- the multi-tensor table and the split --------------------------------

Plan = collections.namedtuple("Plan", "rows first n_groups")
Plan.__doc__ = """One multi-tensor compress launch's device table and split.

``rows``: a ``_ROW_DTYPE`` row per non-empty tensor, in order: the
gradient's, residual slot's and code slot's pointers, the element count,
the first group in the call's flat sequence of 512-element groups (each
tensor starts a new group) and ``vec``, 1 when all three pointers are
16-byte aligned (four float4 loads of each input and one 16-byte store of
codes a thread; else a loop of one element a lane). The ``n_groups``
groups are cut into tiles of ``TILE_GROUPS``; ``first``: per tile, the
row holding its first group. The kernel's ``B`` blocks take tiles ``b,
b + B, ...``, warp ``w`` of a block group ``w`` of each tile."""


def plan(ptrs, sizes):
    """The :class:`Plan` of one launch, a pure function of the tensors'
    pointers (``(n, 3)``: gradient, residual slot, code slot) and element
    counts. Empty tensors get no row."""
    sizes = _np.asarray(sizes, dtype=_np.int64)
    ptrs = _np.asarray(ptrs, dtype=_np.uint64).reshape(len(sizes), 3)
    keep = sizes > 0
    n = sizes[keep]
    groups = (n + GROUP - 1) // GROUP
    ends = _np.cumsum(groups)
    rows = _np.zeros(len(n), _ROW_DTYPE)
    for j, field in enumerate(("grad", "res", "codes")):
        rows[field] = ptrs[keep, j]
    rows["n"] = n
    rows["begin"] = ends - groups
    rows["vec"] = _np.bitwise_or.reduce(ptrs[keep], axis=1) % 16 == 0
    total = int(ends[-1]) if len(n) else 0
    starts = _np.arange(0, total, TILE_GROUPS, dtype=_np.int64)
    first = _np.searchsorted(ends, starts, side="right").astype(_np.int32)
    return Plan(rows, first, total)


_TABLES = _Tables()


# ---- CUDA wrappers -------------------------------------------------------

def _launcher(symbol, argtypes):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.library("twobit"), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _wave(which, device):
    """Blocks of one full wave on ``device`` of the multi-tensor compress
    (``which`` 0) or the int8 decompress (1), asked of the card once per
    device."""
    key = (which, device.index)
    blocks = _waves.get(key)
    if blocks is None:
        fn = build.library("twobit").mxtt_twobit_wave
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = fn(which, ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"twobit: occupancy query failed with CUDA "
                               f"error {rc}")
        blocks = _waves[key] = out.value
    return blocks


def _aligned(tensors_and_bytes):
    return all(t.data_ptr() % b == 0 for t, b in tensors_and_bytes)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def twobit_compress(grad, residual, thr):
    """Launch the compress kernel on CUDA tensors of one shape and one
    dtype (float32, float16 or bfloat16); returns new ``(codes int8,
    new_residual)`` tensors."""
    if grad.device.type != "cuda" or residual.device != grad.device:
        raise ValueError(f"twobit_compress: grad on {grad.device} and "
                         f"residual on {residual.device}; both must be on "
                         "one CUDA card")
    if grad.dtype not in _DTYPE_CODE or residual.dtype != grad.dtype:
        raise ValueError(f"twobit_compress: grad {grad.dtype} and residual "
                         f"{residual.dtype}; the kernel takes one of "
                         "float32, float16, bfloat16 for both")
    if grad.shape != residual.shape:
        raise ValueError(f"twobit_compress: grad {tuple(grad.shape)} and "
                         f"residual {tuple(residual.shape)} differ")
    grad, residual = grad.contiguous(), residual.contiguous()
    codes = torch.empty(grad.shape, dtype=torch.int8, device=grad.device)
    new_res = torch.empty_like(grad)
    n = grad.numel()
    if n == 0:
        return codes, new_res
    # a 16-byte vector of 4 float32 or 8 halves gives that many codes
    vec = _aligned(((grad, 16), (residual, 16), (new_res, 16),
                    (codes, 16 // grad.element_size())))
    with torch.cuda.device(grad.device):
        rc = _launcher("mxtt_twobit_compress", [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p])(
            grad.data_ptr(), residual.data_ptr(), codes.data_ptr(),
            new_res.data_ptr(), _DTYPE_CODE[grad.dtype], n,
            round_threshold(thr, grad.dtype), int(vec), _stream(grad))
    if rc != 0:
        raise RuntimeError(f"twobit_compress: kernel launch failed with CUDA "
                           f"error {rc} for {n} elements")
    count(twobit_compress)
    return codes, new_res


def twobit_decompress(codes, thr, dtype=torch.float32):
    """Launch the decompress kernel on CUDA int8 or int32 codes; returns
    a new tensor of their shape in ``dtype`` (float32, float16 or
    bfloat16)."""
    if codes.device.type != _DEVICE_TYPE:
        raise ValueError(f"twobit_decompress: codes on {codes.device}; the "
                         "kernel takes a CUDA tensor")
    if codes.dtype not in _CODE_BYTES:
        raise ValueError(f"twobit_decompress: codes are {codes.dtype}; the "
                         "kernel takes int8 or int32")
    dtype = canonical_dtype(dtype)
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"twobit_decompress: output dtype {dtype}; the "
                         "kernel writes float32, float16 or bfloat16")
    codes = codes.contiguous()
    out = torch.empty(codes.shape, dtype=dtype, device=codes.device)
    n = codes.numel()
    if n == 0:
        return out
    dev = codes.device
    vec = _aligned(((codes, 16), (out, 16)))
    if codes.dtype == torch.int8:
        path = "vec16" if vec else "scalar"
        blocks = min(_wave(1, dev), -(-n // (GROUP * TILE_GROUPS)))
    else:
        path, blocks = "int32", 0
    args = (codes.data_ptr(), _CODE_BYTES[codes.dtype], out.data_ptr(),
            _DTYPE_CODE[dtype], n, round_threshold(thr, dtype), int(vec),
            blocks, torch.cuda.current_stream(dev).cuda_stream)
    launcher = _launcher("mxtt_twobit_decompress", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    rc = _on(dev, launcher, args)
    if rc != 0:
        raise RuntimeError(f"twobit_decompress: kernel launch failed with "
                           f"CUDA error {rc} for {n} elements")
    count(twobit_decompress)
    count(twobit_decompress, "launches_by_path", path)
    return out


def _on(dev, launcher, args):
    """``launcher(*args)`` with ``dev`` current (switched only when it is
    not: the switch costs host time on every call)."""
    if dev.index == torch.cuda.current_device():
        return launcher(*args)
    with torch.cuda.device(dev):
        return launcher(*args)


def _check_multi(grads, residuals, codes):
    """Every tensor of a key set not seen before."""
    dev = residuals[0].device
    for i, (g, r, c) in enumerate(zip(grads, residuals, codes)):
        for t in (g, r, c):
            if t.device.type != _DEVICE_TYPE or t.device != dev:
                raise DeviceError(f"twobit_compress_multi: tensor {i} is on "
                                  f"{t.device}; all tensors must be on one "
                                  f"CUDA card ({dev})")
        if g.dtype != torch.float32 or r.dtype != torch.float32 or \
                c.dtype != torch.int8:
            raise ValueError(f"twobit_compress_multi: tensor {i} has grad "
                             f"{g.dtype}, residual {r.dtype}, codes "
                             f"{c.dtype}; the kernel takes float32, float32, "
                             "int8")
        if not g.numel() == r.numel() == c.numel():
            raise ValueError(f"twobit_compress_multi: tensor {i} sizes "
                             f"{g.numel()}, {r.numel()}, {c.numel()} differ")
        if not (r.is_contiguous() and c.is_contiguous()):
            raise ValueError(f"twobit_compress_multi: tensor {i}'s residual "
                             "and codes are written in place and must be "
                             "contiguous")
    out = [_PTR(t) for t in itertools.chain(residuals, codes) if t.numel()]
    if len(set(out)) != len(out):
        raise ValueError("twobit_compress_multi: two outputs share one "
                         "buffer")


def twobit_compress_multi(grads, residuals, codes, thr):
    """One launch of the multi-tensor compress over every listed float32
    gradient, writing each one's int8 codes into ``codes[i]`` and its new
    residual into ``residuals[i]`` in place."""
    if not grads or not len(grads) == len(residuals) == len(codes):
        raise ValueError("twobit_compress_multi: empty or unequal tensor "
                         "lists")
    fn = twobit_compress_multi
    given = grads
    if not all(map(_CONTIG, grads)):
        # a copy only for a gradient that is not contiguous, counted;
        # alive until the launch
        grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
        count(fn, "copies",
              n=sum(a is not b for a, b in zip(grads, given)))
    flat = list(itertools.chain(grads, residuals, codes))
    key = (tuple(map(_PTR, flat)), tuple(map(_NUMEL, flat)),
           frozenset(map(_DTYPE, flat)), frozenset(map(_DEVICE_INDEX, flat)),
           all(map(_CONTIG, itertools.chain(residuals, codes))))
    table = _TABLES.get(key)
    dev = residuals[0].device
    if table is None:
        _check_multi(grads, residuals, codes)
        ptrs = _np.asarray(key[0], _np.uint64).reshape(3, len(grads)).T
        table = _Table(plan(ptrs, key[1][:len(grads)]), dev, _wave(0, dev))
        _TABLES.put(key, table)
    if table.n_tensors == 0:
        return
    base = table.buf.data_ptr()
    args = (base, base + table.first_offset, table.n_tensors, table.n_groups,
            table.n_blocks, float(thr),
            torch.cuda.current_stream(dev).cuda_stream)
    launcher = _launcher("mxtt_twobit_compress_multi", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    rc = _on(dev, launcher, args)
    if rc != 0:
        raise RuntimeError(f"twobit_compress_multi: kernel launch failed "
                           f"with CUDA error {rc} over {table.n_tensors} "
                           "tensors")
    count(fn)
    count(fn, "tensors_by_path", "vec16", table.n_vec)
    count(fn, "tensors_by_path", "scalar", table.n_scalar)


twobit_compress.launches = 0
# launches, and launches by path ("vec16": int8 codes and output 16-byte
# aligned, ragged tail aside; "scalar": int8, one code a lane; "int32")
twobit_decompress.launches = 0
twobit_decompress.launches_by_path = {"vec16": 0, "scalar": 0, "int32": 0}
# launches; tensors by path (summed over launches: "vec16" moved 16 bytes
# a thread, ragged tail aside; "scalar" had a misaligned pointer); copies
# of gradients that were not contiguous
twobit_compress_multi.launches = 0
twobit_compress_multi.tensors_by_path = {"vec16": 0, "scalar": 0}
twobit_compress_multi.copies = 0


def _compress_flops(grad, residual, thr):
    """K6, elementwise: 5 per element (the residual's add, two compares,
    the code's multiply by the threshold, the subtract)."""
    return 5 * grad.numel(), "float"


def _decompress_flops(codes, thr, dtype=torch.float32):
    """K7, elementwise: 1 per element (the multiply)."""
    return codes.numel(), "float"


def _compress_multi_flops(grads, residuals, codes, thr):
    """K6 over every listed gradient: 5 per element."""
    return 5 * sum(g.numel() for g in grads), "float"


def _in_place(*args, **kwargs):
    """The shape inference of the in-place compress: no output."""
    return None


def _register():
    from . import register_kernel

    register_kernel(
        "twobit_compress", kernel=twobit_compress,
        plain=twobit_compress_plain, flops=_compress_flops,
        replaces="mxnet_tpu/kernels/twobit.py:_kernel_compress",
        tolerance="bit-exact vs the plain version and _xla_compress "
                  "(correctly rounded add, multiply and subtract)")
    register_kernel(
        "twobit_decompress", kernel=twobit_decompress,
        plain=twobit_decompress_plain, flops=_decompress_flops,
        replaces="mxnet_tpu/kernels/twobit.py:_kernel_decompress",
        tolerance="bit-exact (the code rounded to the output dtype, one "
                  "correctly rounded multiply)")
    register_kernel(
        "twobit_compress_multi", kernel=twobit_compress_multi,
        plain=twobit_compress_multi_plain, flops=_compress_multi_flops,
        infer=_in_place,
        replaces="mxnet_tpu/kernels/twobit.py:_kernel_compress",
        tolerance="bit-exact vs the per-tensor plain version and "
                  "_xla_compress (correctly rounded add, multiply and "
                  "subtract)", checks_devices=True)


_register()
