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

What bounds the kernel: memory. Adam reads w, g, mean, var and writes w,
mean, var: 28 bytes per parameter; SGD-momentum 20. For BERT-base's
109 M parameters that is 0.91 and 0.65 ms at 3.35 TB/s. The kernel moves
16 bytes a thread wherever a tensor's operands are 16-byte aligned and
deals the step's elements, in tiles of 4096, round-robin to one wave of
blocks (``csrc/opt_step.cu`` says how). Measured over those 197 tensors
on an NVIDIA H100 80GB HBM3 at 700 W (``tools/opt_abba.py``, both
designs in one call): 1.040 ms (Adam) and 0.739 ms (SGD-momentum) of
device time, 88% of the bounds, against 1.167 and 0.790 for the earlier
design (scalar loads, 16384-element chunks dealt round-robin, a search
of the table per chunk, every tensor checked on every call); host time
per call 0.33-0.82 ms against 0.81-1.43.

The host's part is built once per parameter set. :func:`plan` turns the
tensors' pointers, sizes and weight decays into the device table (one
56-byte row per tensor) and the split (the row each tile of 4096
elements starts in);
the table goes to the card from one pinned staging buffer without a host
sync. Each family keeps the tables of its last few parameter sets, keyed
by a fingerprint of every tensor (pointer, shape, dtype, device, and
whether the tensors updated in place are contiguous) and the weight
decays. A call whose fingerprint was seen before reuses its table and
skips the per-tensor checks, which passed for that very fingerprint; any
other call is checked in full (the same ``ValueError``s) before a table
is built. Gradients come fresh from autograd every step, but the caching
allocator returns the same addresses, so at steady state every call hits,
and so do the alternating calls of several learning-rate groups.

Under CUDA graph capture (``compile.py``) a table's upload cannot run
as it does eagerly: it waits on an event and copies from a shared
pinned buffer, which a graph would replay from a host address whose
bytes have changed. So a table first met inside a capture is allocated
there, outside the capture's memory pool, and filled from the host when
the capture ends (``kernels.after_capture``), before the graph's first
replay; the captured kernel reads it at every replay. A miss inside a
capture that is not the compile service's (no record to defer to) raises
:class:`~mxnet_tpu_torch.compile.CaptureError` naming ``opt_step``. A
launch inside a capture hands its table to ``kernels.keep``, so a graph
holds every table it reads even after the cache evicts it.

Contract: bit-exact against the plain versions for float32 (the kernel
uses correctly rounded intrinsics in the op order of
``ops/optimizer_op.py``); only float32 tensors are taken.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import operator

import numpy as _np
import torch

from ..ops import optimizer_op as _op
from . import DeviceError, after_capture, build, count, keep

__all__ = ["opt_sgd", "opt_adam", "opt_sgd_plain", "opt_adam_plain", "plan",
           "Plan"]

# one 56-byte row per tensor, the layout of TensorDesc in csrc/opt_step.cu
_TABLE_DTYPE = _np.dtype([("w", "<u8"), ("g", "<u8"), ("s0", "<u8"),
                          ("s1", "<u8"), ("n", "<i8"), ("begin", "<i8"),
                          ("wd", "<f4"), ("vec", "<i4")])
assert _TABLE_DTYPE.itemsize == 56
GROUP = 4            # elements per 16-byte group
TILE_GROUPS = 1024   # groups per tile, kTileGroups in csrc/opt_step.cu
TABLES_PER_FAMILY = 8
_DEVICE_TYPE = "cuda"  # the device the kernels take

_PTR = torch.Tensor.data_ptr
_CONTIG = torch.Tensor.is_contiguous
_DIM = torch.Tensor.dim
_SHAPE = operator.attrgetter("shape")
_DTYPE = operator.attrgetter("dtype")
_DEVICE = operator.attrgetter("device")

_fns = {}
_waves = {}    # (symbol, device index) -> blocks of one full wave


def _launcher(symbol, n_floats):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.library("opt_step"), symbol)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p] + [ctypes.c_float] * n_floats + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _wave(symbol, device):
    """Blocks of one full wave of the kernel on ``device``: occupancy
    times SMs, asked of the card once per device."""
    key = (symbol, device.index)
    blocks = _waves.get(key)
    if blocks is None:
        fn = build.library("opt_step").mxtt_opt_wave
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = fn(int(symbol == "mxtt_opt_adam"), ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"{symbol}: occupancy query failed with CUDA "
                               f"error {rc}")
        blocks = _waves[key] = out.value
    return blocks


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


# ---- the table and the split ---------------------------------------------

Plan = collections.namedtuple("Plan", "rows first n_groups")
Plan.__doc__ = """One launch's device table and work split.

``rows``: a ``_TABLE_DTYPE`` row per non-empty tensor, in order: its
operand pointers, element count, first group in the step's flat sequence
of 4-element groups (each tensor starts a new group), weight decay and
``vec``, 1 when every operand is 16-byte aligned (the float4 path; else
the scalar loop). The ``n_groups`` groups are cut into tiles of
``TILE_GROUPS``; ``first``: per tile, the row holding its first group.
The kernel's ``B`` blocks take tiles ``b, b + B, ...``."""


def plan(ptrs, sizes, wds):
    """The :class:`Plan` of one launch, a pure function of the tensors'
    operand pointers (``(n, 4)``, 0 for an absent operand), element
    counts and weight decays. Empty tensors get no row."""
    sizes = _np.asarray(sizes, dtype=_np.int64)
    ptrs = _np.asarray(ptrs, dtype=_np.uint64).reshape(len(sizes), 4)
    keep = sizes > 0
    n = sizes[keep]
    groups = (n + GROUP - 1) // GROUP
    ends = _np.cumsum(groups)
    rows = _np.zeros(len(n), _TABLE_DTYPE)
    for j, field in enumerate(("w", "g", "s0", "s1")):
        rows[field] = ptrs[keep, j]
    rows["n"] = n
    rows["begin"] = ends - groups
    rows["wd"] = _np.asarray(wds, dtype=_np.float32)[keep]
    rows["vec"] = _np.bitwise_or.reduce(ptrs[keep], axis=1) % 16 == 0
    total = int(ends[-1]) if len(n) else 0
    starts = _np.arange(0, total, TILE_GROUPS, dtype=_np.int64)
    first = _np.searchsorted(ends, starts, side="right").astype(_np.int32)
    return Plan(rows, first, total)


class _Staging:
    """One pinned host buffer from which tables are copied to the card
    without a host sync; a later build waits for the previous copy."""

    def __init__(self):
        self.host = None
        self.copied = None

    def upload(self, data, device):
        if self.copied is not None:
            self.copied.synchronize()
        if self.host is None or self.host.numel() < data.size:
            self.host = torch.empty(max(data.size, 1 << 16),
                                    dtype=torch.uint8, pin_memory=True)
        host = self.host[:data.size]
        host.numpy()[:] = data
        out = torch.empty(data.size, dtype=torch.uint8, device=device)
        out.copy_(host, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record(torch.cuda.current_stream(device))
        return out


_STAGING = _Staging()


_SIDE = {}  # device -> a stream that never captures
_CAPTURE_MODE_RELAXED = 2  # CU_STREAM_CAPTURE_MODE_RELAXED


@contextlib.contextmanager
def _relaxed_capture_mode():
    """This thread's stream-capture mode relaxed for the scope (the
    driver's ``cuThreadExchangeStreamCaptureMode``), as PyTorch's
    allocator relaxes it around a ``cudaMalloc`` during a capture: a
    capture in ``thread_local`` mode refuses this thread's
    ``cudaMalloc``, which allocates outside any stream's order."""
    exchange = ctypes.CDLL("libcuda.so.1").cuThreadExchangeStreamCaptureMode
    mode = ctypes.c_int(_CAPTURE_MODE_RELAXED)
    rc = exchange(ctypes.byref(mode))
    if rc != 0:
        raise RuntimeError(f"opt_step: cuThreadExchangeStreamCaptureMode "
                           f"failed with CUDA error {rc}")
    try:
        yield
    finally:
        exchange(ctypes.byref(mode))


def _upload(data, device):
    """``data`` (uint8 numpy) as a tensor on ``device``; inside a capture
    the tensor is filled when the capture ends. It is allocated on a
    stream that is not capturing, so from the card's ordinary memory: a
    block of the capture's own pool may be one that the graph writes
    earlier in each replay (memory the capture freed and reused)."""
    if not torch.cuda.is_current_stream_capturing():
        return _STAGING.upload(data, device)
    with _relaxed_capture_mode():
        side = _SIDE.get(device)
        if side is None:
            side = _SIDE[device] = torch.cuda.Stream(device)
        with torch.cuda.stream(side):
            out = torch.empty(data.size, dtype=torch.uint8, device=device)
    host = torch.from_numpy(data.copy())
    if not after_capture(lambda: out.copy_(host)):
        from ..compile import CaptureError

        raise CaptureError(
            "opt_step: a parameter set's table cannot be uploaded inside a "
            "CUDA graph capture (the copy would bake a host address into "
            "the graph); capture through mxnet_tpu_torch.compile.jit, "
            "which fills it when the capture ends, or run the same "
            "operands once eagerly first")
    return out


class _Table:
    """A :class:`Plan` on the card, ``first`` at byte ``first_offset`` of
    one buffer after the rows, and the launch's block count: one wave, or
    fewer where there are fewer tiles."""

    __slots__ = ("buf", "first_offset", "n_tensors", "n_groups", "n_blocks",
                 "n_vec", "n_scalar")

    def __init__(self, p, device, wave):
        self.buf = _upload(_np.concatenate(
            [p.rows.view(_np.uint8), p.first.view(_np.uint8)]), device)
        self.first_offset = p.rows.nbytes
        self.n_tensors = len(p.rows)
        self.n_groups = p.n_groups
        self.n_blocks = min(wave, len(p.first))
        self.n_vec = int(p.rows["vec"].sum())
        self.n_scalar = self.n_tensors - self.n_vec


class _Tables:
    """The tables of one family's last ``capacity`` parameter sets, by
    fingerprint; the oldest built goes first. (A hit does not reorder:
    that would hash the long key a second time.)"""

    def __init__(self, capacity=TABLES_PER_FAMILY):
        self.capacity = capacity
        self.by_key = {}
        self.builds = 0

    def get(self, key):
        return self.by_key.get(key)

    def put(self, key, table):
        self.by_key[key] = table
        self.builds += 1
        while len(self.by_key) > self.capacity:
            del self.by_key[next(iter(self.by_key))]


_TABLES = {"opt_sgd": _Tables(), "opt_adam": _Tables()}


# ---- CUDA wrappers -------------------------------------------------------

def _check_scalars(family, dev, lr, skip):
    for t in (lr,) if skip is None else (lr, skip):
        if t.device != dev or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"{family}: lr and skip must be float32 scalars "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def _check(family, lists, wds):
    """Every tensor of a parameter set not seen before."""
    dev = lists[0][0].device
    if len(wds) != len(lists[0]):
        raise ValueError(f"{family}: {len(wds)} weight decays for "
                         f"{len(lists[0])} tensors")
    for i, group in enumerate(zip(*lists)):
        w = group[0]
        for t in group:
            if t.device.type != _DEVICE_TYPE or t.device != dev:
                raise DeviceError(f"{family}: tensor {i} is on {t.device}; "
                                  f"all tensors must be on one CUDA card "
                                  f"({dev})")
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
    ptrs = [_PTR(t) for t in itertools.chain(*lists) if t.numel()]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError(f"{family}: two operands share one buffer")


def _step(fn, family, symbol, floats, lists, lr, wds, skip):
    """Check (or recognise) the parameter set, then launch over it."""
    weights = lists[0]
    if not weights or any(len(x) != len(weights) for x in lists):
        raise ValueError(f"{family}: empty or unequal tensor lists")
    dev = weights[0].device
    _check_scalars(family, dev, lr, skip)
    grads = lists[1]
    if not all(map(_CONTIG, grads)):
        # a copy only for a gradient that is not contiguous, counted;
        # alive until the launch
        grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
        count(fn, "copies",
              n=sum(a is not b for a, b in zip(grads, lists[1])))
        lists = [weights, grads, *lists[2:]]
    flat = list(itertools.chain(*lists))
    inplace = itertools.chain(weights, *lists[2:])
    # shapes as their dims and one run of ints: hashed and compared as
    # ints, several times faster than a tuple of torch.Size
    key = (tuple(map(_PTR, flat)), tuple(map(_DIM, flat)),
           tuple(itertools.chain.from_iterable(map(_SHAPE, flat))),
           frozenset(map(_DTYPE, flat)), frozenset(map(_DEVICE, flat)),
           all(map(_CONTIG, inplace)), tuple(wds))
    tables = _TABLES[family]
    table = tables.get(key)
    if table is None:
        _check(family, lists, wds)
        n = len(weights)
        ptrs = _np.zeros((n, 4), _np.uint64)
        ptrs[:, :len(lists)] = _np.asarray(key[0], _np.uint64).reshape(
            len(lists), n).T
        table = _Table(plan(ptrs, [w.numel() for w in weights], wds), dev,
                       _wave(symbol, dev))
        tables.put(key, table)
    if table.n_tensors == 0:
        return
    keep(table)
    base = table.buf.data_ptr()
    args = (base, base + table.first_offset, table.n_tensors,
            table.n_groups, table.n_blocks, lr.data_ptr(),
            skip.data_ptr() if skip is not None else None, *floats,
            torch.cuda.current_stream(dev).cuda_stream)
    launcher = _launcher(symbol, len(floats))
    if dev.index == torch.cuda.current_device():
        rc = launcher(*args)
    else:
        with torch.cuda.device(dev):
            rc = launcher(*args)
    if rc != 0:
        raise RuntimeError(f"{family}: kernel launch failed with CUDA error "
                           f"{rc} over {table.n_tensors} tensors")
    count(fn)
    count(fn, "tensors_by_path", "vec4", table.n_vec)
    count(fn, "tensors_by_path", "scalar", table.n_scalar)


def opt_sgd(weights, grads, moms, lr, wds, *, momentum, rescale_grad=1.0,
            clip_gradient=-1.0, skip=None):
    """One launch of the SGD-momentum kernel over every tensor, in place."""
    _step(opt_sgd, "opt_sgd", "mxtt_opt_sgd_mom",
          (momentum, rescale_grad, clip_gradient), [weights, grads, moms],
          lr, wds, skip)


def opt_adam(weights, grads, means, variances, lr, wds, *, beta1=0.9,
             beta2=0.999, epsilon=1e-8, rescale_grad=1.0, clip_gradient=-1.0,
             skip=None):
    """One launch of the Adam kernel over every tensor, in place. The
    constants ``1 - beta`` are computed in double and rounded once to
    float32, as PyTorch rounds the Python scalars of the plain version."""
    _step(opt_adam, "opt_adam", "mxtt_opt_adam",
          (beta1, 1 - beta1, beta2, 1 - beta2, epsilon, rescale_grad,
           clip_gradient), [weights, grads, means, variances], lr, wds, skip)


# launches; tensors by path (summed over launches: "vec4" moved 16 bytes
# a thread, ragged tail aside; "scalar" had a misaligned operand); copies
# of gradients that were not contiguous
for _fn in (opt_sgd, opt_adam):
    _fn.launches = 0
    _fn.tensors_by_path = {"vec4": 0, "scalar": 0}
    _fn.copies = 0


def _elements(weights):
    return sum(w.numel() for w in weights)


def _sgd_flops(weights, grads, moms, lr, wds, *, momentum,
               rescale_grad=1.0, clip_gradient=-1.0, skip=None):
    """K1, elementwise: 7 per element (``sgd_mom_update``: the rescale,
    the weight decay's multiply and add, the momentum's multiply, the
    learning rate's multiply and subtract, the weight's add), 2 more with
    clipping (a min and a max)."""
    return _elements(weights) * (9 if clip_gradient > 0 else 7), "float"


def _adam_flops(weights, grads, means, variances, lr, wds, *, beta1=0.9,
                beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                clip_gradient=-1.0, skip=None):
    """K2, elementwise: 15 per element (``adam_update``: the rescale, 2
    for the weight decay, 3 for the mean, 4 for the variance, and the
    update's square root, epsilon add, learning-rate multiply, divide and
    subtract), 2 more with clipping."""
    return _elements(weights) * (17 if clip_gradient > 0 else 15), "float"


def _in_place(*args, **kwargs):
    """The shape inference of an in-place family: no output."""
    return None


def _register():
    from . import register_kernel

    tol = ("bit-exact vs ops/optimizer_op.py for float32 (correctly rounded "
           "intrinsics in the same op order)")
    register_kernel("opt_sgd", kernel=opt_sgd, plain=opt_sgd_plain,
                    replaces="mxnet_tpu/kernels/opt_step.py:_kernel_sgd",
                    tolerance=tol, checks_devices=True, flops=_sgd_flops,
                    infer=_in_place)
    register_kernel("opt_adam", kernel=opt_adam, plain=opt_adam_plain,
                    replaces="mxnet_tpu/kernels/opt_step.py:_kernel_adam",
                    tolerance=tol, checks_devices=True, flops=_adam_flops,
                    infer=_in_place)


_register()
