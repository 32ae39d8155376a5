"""Hand-written kernel layer: registry, dispatch and launch counts.

Counterpart of ``mxnet_tpu/kernels/__init__.py``, reduced to one rule.
Each op family registers

* ``kernel``: the wrapper of a kernel written by hand for Hopper, which
  takes CUDA tensors only and counts its launches in ``kernel.launches``
  (and, where the kernel has more than one path, by path in the dict
  ``kernel.launches_by_path``);
* ``plain``: a plain PyTorch version of the same function.

``dispatch(family, *args, ...)`` sends CPU tensors to the plain
version and CUDA tensors to the kernel; it looks at every tensor among
the arguments, in lists and tuples too (the optimizer families take
lists of tensors). A family registered with ``checks_devices`` (the
optimizer families, whose wrappers look at every tensor's device
anyway) goes to its kernel as soon as its first tensor lies on a CUDA
card, with no walk over the rest: the wrapper raises
:class:`DeviceError` on a mix. There is no opt-out, no autotuned table
and no fallback: on the card the kernel launches or the call raises.
Tensors that carry shapes and no data take a third branch, shape
inference: ``meta`` tensors (the symbol's shape inference) and the fake
tensors of a ``FakeTensorMode`` (``ShardedTrainer.aot_lower``) go to the
family's ``infer``, which returns the outputs' shapes and computes
nothing (the plain version run on those tensors; nothing for the
in-place families). Tensors on mixed or other devices raise
:class:`DeviceError`, an ``MXNetError``.

Each family also states its work, ``flops(*args, **kwargs) -> (n,
kind)`` (``kind`` ``"float"`` or ``"int"``). A ctypes launch is
invisible to a ``TorchDispatchMode``, so while one that listens for
kernels is active (``telemetry.costs.counting``, ``aot_lower``'s
recorder: a mode with an ``on_kernel`` method), :func:`dispatch` hands
it the family, its count and kind, on every route, and pauses its
counting of aten ops while the plain version or the shape inference
runs: a call counts the same on the CPU and on the card.

Every counter on a wrapper (``launches``, ``launches_by_path``,
``copies``, ``tensors_by_path``) moves through :func:`count`. While a
CUDA graph is being captured (``compile.py``) nothing is launched:
inside :func:`recording` the counts go to the capture's record, and each
replay of the graph adds that record to the counters
(:func:`add_counts`). So the counters always count what ran on the card.
A capture's record is found by thread (the capturing thread) and, when
:func:`recording` is given the capture stream, by that stream too: a
backward captured through ``torch.autograd`` runs on the autograd
engine's own thread, on the stream of its forward. A wrapper whose
kernel reads a buffer it keeps (a table) hands that buffer to
:func:`keep`: the record holds it for as long as the graph lives. Work
that cannot run inside a capture but that the graph needs before its
first replay (filling a table from the host) goes to
:func:`after_capture`, which the capture runs when it ends.
"""
from __future__ import annotations

import contextlib
import itertools
import threading

import torch

from ..base import MXNetError

__all__ = ["register_kernel", "dispatch", "entry", "launch_counts",
           "reset_launch_counts", "count", "recording", "add_counts",
           "keep", "after_capture", "before_replay", "DeviceError"]

_FAMILIES: dict = {}
_tls = threading.local()
_count_lock = threading.Lock()  # wrappers count from several threads
# raw CUDA stream of a capture in progress -> its record
_by_stream: dict = {}


class DeviceError(MXNetError, ValueError):
    """The tensors of one call lie on mixed devices, or not on the device
    a kernel takes."""


class KernelEntry:
    __slots__ = ("family", "kernel", "plain", "tolerance", "replaces",
                 "checks_devices", "flops", "infer")

    def __init__(self, family, kernel, plain, tolerance, replaces,
                 checks_devices, flops, infer):
        self.family = family
        self.kernel = kernel
        self.plain = plain
        self.tolerance = tolerance
        self.replaces = replaces
        self.checks_devices = checks_devices
        self.flops = flops
        self.infer = infer


def register_kernel(family, *, kernel, plain, tolerance, replaces, flops,
                    checks_devices=False, infer=None):
    """Register an op family. ``tolerance`` states the kernel's numeric
    contract against ``plain``; ``replaces`` names the TPU kernel;
    ``flops`` counts a call's work (``(n, "float" | "int")``);
    ``checks_devices``: the kernel's wrapper refuses tensors on mixed
    devices itself, with :class:`DeviceError`; ``infer``: the shape
    inference of meta and fake tensors (default: ``plain``)."""
    e = KernelEntry(family, kernel, plain, tolerance, replaces,
                    checks_devices, flops, infer or plain)
    _FAMILIES[family] = e
    return e


def _listeners():
    """The active dispatch modes that listen for kernel calls (an
    ``on_kernel`` method): none, at the cost of one C call, when no
    Python dispatch mode is active."""
    if not torch._C._len_torch_dispatch_stack():
        return ()
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return [m for m in _get_current_dispatch_mode_stack()
            if hasattr(m, "on_kernel")]


def _is_fake(t):
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


@contextlib.contextmanager
def _paused(listeners):
    for m in listeners:
        m.paused += 1
    try:
        yield
    finally:
        for m in listeners:
            m.paused -= 1


def entry(family) -> KernelEntry:
    return _FAMILIES[family]


def _tensors(values):
    for a in values:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def dispatch(family, *args, **kwargs):
    """Route one call by the device of its tensor arguments: the kernel
    on a card, the plain version on the CPU, the shape inference for
    meta and fake tensors."""
    e = _FAMILIES[family]
    listeners = _listeners()
    if listeners:
        n, kind = e.flops(*args, **kwargs)
        for m in listeners:
            m.on_kernel(family, n, kind)
    tensors = _tensors(list(args) + list(kwargs.values()))
    if listeners:   # a fake tensor reports its device: look for one first
        tensors = list(tensors)
        if any(_is_fake(t) for t in tensors):
            with _paused(listeners):
                return e.infer(*args, **kwargs)
    elif e.checks_devices:
        first = next(tensors, None)
        if first is not None and first.device.type == "cuda":
            return e.kernel(*args, **kwargs)
        tensors = itertools.chain([first] if first is not None else [],
                                  tensors)
    devices = {t.device.type for t in tensors}
    if devices == {"meta"}:
        with _paused(listeners):
            return e.infer(*args, **kwargs)
    if devices == {"cpu"}:
        with _paused(listeners):
            return e.plain(*args, **kwargs)
    if devices == {"cuda"}:
        return e.kernel(*args, **kwargs)
    raise DeviceError(f"{family}: tensors on devices {sorted(devices)}; "
                      "expected all on the CPU or all on one CUDA card")


def launch_counts():
    """``{family: launches}`` of every registered kernel wrapper, and
    ``{"family.path": launches}`` for a wrapper that counts by path."""
    counts = {}
    for f, e in sorted(_FAMILIES.items()):
        counts[f] = e.kernel.launches
        for path, n in getattr(e.kernel, "launches_by_path", {}).items():
            counts[f"{f}.{path}"] = n
    return counts


class Record(dict):
    """A capture's counts ``{(wrapper, counter, path): n}``; ``kept``
    holds the buffers its kernels read (:func:`keep`), ``after`` the
    work to run when the capture ends (:func:`after_capture`),
    ``before`` the work to run before each replay
    (:func:`before_replay`)."""

    def __init__(self):
        super().__init__()
        self.kept = []
        self.after = []
        self.before = {}


def _record():
    """The record this call counts into: this thread's, else that of
    the capture on the current stream, else None."""
    record = getattr(_tls, "record", None)
    if record is None and _by_stream:
        record = _by_stream.get(torch._C._cuda_getCurrentRawStream(
            torch.cuda.current_device()))
    return record


def count(fn, attr="launches", path=None, n=1):
    """Add ``n`` to the wrapper ``fn``'s counter ``attr`` (to its entry
    ``path`` when the counter is a dict), or to the record of the capture
    it launches into (:func:`recording`)."""
    record = _record()
    if record is not None:
        key = (fn, attr, path)
        record[key] = record.get(key, 0) + n
        return
    with _count_lock:
        if path is None:
            setattr(fn, attr, getattr(fn, attr) + n)
        else:
            getattr(fn, attr)[path] += n


def keep(obj):
    """Hold ``obj`` (a buffer a kernel launched now reads) in the record
    of the capture the launch goes into; nothing outside a capture."""
    record = _record()
    if record is not None:
        record.kept.append(obj)


def after_capture(work):
    """Defer ``work()`` to the end of the capture the current launch goes
    into; False (and nothing deferred) outside a :func:`recording`."""
    record = _record()
    if record is None:
        return False
    record.after.append(work)
    return True


def before_replay(key, work):
    """Run ``work()`` on the host before every replay of the graph being
    captured (once per ``key``); False (and nothing kept) outside a
    :func:`recording`."""
    record = _record()
    if record is None:
        return False
    record.before.setdefault(key, work)
    return True


@contextlib.contextmanager
def recording(stream=None):
    """Within the scope, this thread's counts, and those of any thread
    launching on ``stream`` (a capture stream), go to the
    :class:`Record` it yields instead of the counters."""
    prev = getattr(_tls, "record", None)
    record = _tls.record = Record()
    key = stream.cuda_stream if stream is not None else None
    if key is not None:
        _by_stream[key] = record
    try:
        yield record
    finally:
        _tls.record = prev
        if key is not None:
            _by_stream.pop(key, None)


def add_counts(record):
    """Add a :func:`recording`'s counts to the counters (one replay)."""
    for (fn, attr, path), n in record.items():
        count(fn, attr, path, n)


def reset_launch_counts():
    for e in _FAMILIES.values():
        e.kernel.launches = 0
        paths = getattr(e.kernel, "launches_by_path", {})
        for path in paths:
            paths[path] = 0


from . import flash  # noqa: E402,F401  (flash_attention, its backward)
from . import opt_step  # noqa: E402,F401  (opt_sgd, opt_adam)
from . import int8_gemm  # noqa: E402,F401  (int8_gemm)
from . import decode_attention  # noqa: E402,F401  (decode_attention)
from . import twobit  # noqa: E402,F401  (twobit_compress, twobit_decompress)
