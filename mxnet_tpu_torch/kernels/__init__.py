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
``meta`` tensors, which carry shapes and no data (the symbol's shape
inference), take the plain version too. Tensors on mixed or other
devices raise :class:`DeviceError`, an ``MXNetError``.

Every counter on a wrapper (``launches``, ``launches_by_path``,
``copies``, ``tensors_by_path``) moves through :func:`count`. On a
thread that is capturing a CUDA graph (``compile.py``) nothing is
launched: inside :func:`recording` the counts go to the capture's
record, and each replay of the graph adds that record to the counters
(:func:`add_counts`). So the counters always count what ran on the card.
"""
from __future__ import annotations

import contextlib
import itertools
import threading

import torch

from ..base import MXNetError

__all__ = ["register_kernel", "dispatch", "entry", "launch_counts",
           "reset_launch_counts", "count", "recording", "add_counts",
           "DeviceError"]

_FAMILIES: dict = {}
_tls = threading.local()
_count_lock = threading.Lock()  # wrappers count from several threads


class DeviceError(MXNetError, ValueError):
    """The tensors of one call lie on mixed devices, or not on the device
    a kernel takes."""


class KernelEntry:
    __slots__ = ("family", "kernel", "plain", "tolerance", "replaces",
                 "checks_devices")

    def __init__(self, family, kernel, plain, tolerance, replaces,
                 checks_devices):
        self.family = family
        self.kernel = kernel
        self.plain = plain
        self.tolerance = tolerance
        self.replaces = replaces
        self.checks_devices = checks_devices


def register_kernel(family, *, kernel, plain, tolerance, replaces,
                    checks_devices=False):
    """Register an op family. ``tolerance`` states the kernel's numeric
    contract against ``plain``; ``replaces`` names the TPU kernel;
    ``checks_devices``: the kernel's wrapper refuses tensors on mixed
    devices itself, with :class:`DeviceError`."""
    e = KernelEntry(family, kernel, plain, tolerance, replaces,
                    checks_devices)
    _FAMILIES[family] = e
    return e


def entry(family) -> KernelEntry:
    return _FAMILIES[family]


def _tensors(values):
    for a in values:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


def dispatch(family, *args, **kwargs):
    """Route one call by the device of its tensor arguments."""
    e = _FAMILIES[family]
    tensors = _tensors(list(args) + list(kwargs.values()))
    if e.checks_devices:
        first = next(tensors, None)
        if first is not None and first.device.type == "cuda":
            return e.kernel(*args, **kwargs)
        tensors = itertools.chain([first] if first is not None else [],
                                  tensors)
    devices = {t.device.type for t in tensors}
    if devices in ({"cpu"}, {"meta"}):
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


def count(fn, attr="launches", path=None, n=1):
    """Add ``n`` to the wrapper ``fn``'s counter ``attr`` (to its entry
    ``path`` when the counter is a dict), or to this thread's capture
    record inside :func:`recording`."""
    record = getattr(_tls, "record", None)
    if record is not None:
        key = (fn, attr, path)
        record[key] = record.get(key, 0) + n
        return
    with _count_lock:
        if path is None:
            setattr(fn, attr, getattr(fn, attr) + n)
        else:
            getattr(fn, attr)[path] += n


@contextlib.contextmanager
def recording():
    """Within the scope, this thread's counts go to the dict it yields,
    ``{(wrapper, counter, path): n}``, instead of the counters."""
    prev = getattr(_tls, "record", None)
    _tls.record = {}
    try:
        yield _tls.record
    finally:
        _tls.record = prev


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
