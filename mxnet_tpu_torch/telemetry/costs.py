"""Cost telemetry (counterpart of ``mxnet_tpu/telemetry/costs.py``):
per-entry flop records, the peak table, and the measured-MFU arithmetic.

* **The numerator.** The JAX package records XLA's ``cost_analysis()``
  when it compiles. A CUDA graph has no cost analysis, so the port counts:
  the compile service (:mod:`mxnet_tpu_torch.compile`) runs the call that
  makes an entry (the eager first call of a captured step or forward, the
  first plain call on the CPU) under :func:`counting`, a
  ``TorchDispatchMode`` that adds, per aten op, the count of
  ``torch.utils.flop_counter``'s table (matrix products, convolutions and
  their backward, attention), and the formula of each hand-written
  kernel family that ``kernels.dispatch`` reaches (``kernels/
  __init__.py``: ctypes launches are invisible to a dispatch mode; the
  family's plain version, which the CPU runs, is not counted op by op, so
  a step counts the same on the CPU and on the card). Elementwise aten
  ops are not counted (XLA's count has them: the gap of
  ``tests/test_torch_telemetry.py``). The entry's record goes in under
  the function's token (``record_executable``); a replay's flops are its
  capture's. Integer operations (the int8 GEMM) are kept apart, under
  ``int_ops``.
* **Memory.** A CUDA graph has no ``memory_analysis()``: the port
  records the bytes the capture's private memory pool took (the caching
  allocator's reserved bytes across the capture) as ``temp_bytes``, and 0
  for ``argument_bytes``, ``output_bytes``, ``generated_code_bytes`` and
  ``alias_bytes``, which it does not measure.
* **The denominator** is the peak table below, by device kind: NVIDIA's
  dense bf16 peaks of the H100 (datasheet: SXM 989.4, PCIe 756.5
  TFLOP/s) ahead of the JAX package's TPU rows. With no argument the kind
  is ``torch.cuda.get_device_name()``, or ``"cpu"`` without a card;
  ``BENCH_PEAK_TFLOPS`` overrides it.

``ShardedTrainer.step_report()`` reports ``mfu_xla`` = ``flops/step x
steps/s / (peak x devices)``, under the JAX package's name.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

from . import _state

__all__ = ["PEAK_TFLOPS_TABLE", "CPU_FALLBACK_TFLOPS",
           "nominal_peak_tflops", "peak_tflops", "record_executable",
           "flops_for", "latest", "records", "aggregate", "mfu_xla",
           "reset", "counting", "FlopCount"]

# nominal dense bf16 peak per device kind (public specs), first match
# wins: 'h100 pcie' before the bare 'h100' (the SXM part, whose name is
# "NVIDIA H100 80GB HBM3"), 'v5 lite'/'v5e' before the bare 'v5'. The
# 'cpu' entry is a placeholder (1 TFLOP/s): a CPU ratio is never a device
# number.
CPU_FALLBACK_TFLOPS = 1.0
PEAK_TFLOPS_TABLE = (
    ("h100 pcie", 756.5), ("h100", 989.4),
    ("v6e", 918.0), ("v6", 918.0),
    ("v5 lite", 197.0), ("v5e", 197.0),
    ("v5p", 459.0), ("v5", 459.0),
    ("v4", 275.0), ("v3", 123.0),
    ("cpu", CPU_FALLBACK_TFLOPS),
)

_MAX_TOKENS = 512    # distinct executables tracked (FIFO eviction)
_PER_SITE = 64       # recent records kept per site

_lock = threading.Lock()
_by_token: dict = {}            # token_key -> record (insertion-ordered)
_by_site: dict = {}             # site -> deque of records
_agg: dict = {}                 # site -> aggregate sums


def nominal_peak_tflops(device_kind=None) -> float:
    """Table lookup by device kind (default: ``torch.cuda.
    get_device_name()``, or ``"cpu"`` without a card); 459 when nothing
    matches, as in the JAX package."""
    kind = device_kind
    if kind is None:
        import torch

        kind = torch.cuda.get_device_name() if torch.cuda.is_available() \
            else "cpu"
    kind = str(kind).lower()
    for key, peak in PEAK_TFLOPS_TABLE:
        if key in kind:
            return peak
    return 459.0


def peak_tflops(device_kind=None, env="BENCH_PEAK_TFLOPS") -> float:
    """The effective per-device peak: the ``env`` override when set to a
    positive number ("0"/unset mean auto-detect), else the table."""
    try:
        override = float(os.environ.get(env, 0) or 0)
    except ValueError:
        override = 0.0
    return override if override > 0 else nominal_peak_tflops(device_kind)


# ---------------------------------------------------- executable records ---

def _norm_cost(cost):
    """A cost dict (``cost_analysis()``'s keys, and ``"int ops"``) as
    {flops, bytes_accessed, transcendentals, int_ops}."""
    if cost is None:
        return {}
    try:
        return {"flops": float(cost.get("flops", 0.0)),
                "bytes_accessed": float(cost.get("bytes accessed", 0.0)),
                "transcendentals": float(cost.get("transcendentals", 0.0)),
                "int_ops": float(cost.get("int ops", 0.0))}
    except (AttributeError, TypeError, ValueError):
        return {}


_MEM_FIELDS = (("argument_bytes", "argument_size_in_bytes"),
               ("output_bytes", "output_size_in_bytes"),
               ("temp_bytes", "temp_size_in_bytes"),
               ("generated_code_bytes", "generated_code_size_in_bytes"),
               ("alias_bytes", "alias_size_in_bytes"))


def _norm_mem(mem):
    """A ``{"temp_size_in_bytes": n, ...}`` dict (the port's captured
    pool bytes under XLA's field names) as plain byte fields."""
    if mem is None:
        return {}
    out = {}
    for name, attr in _MEM_FIELDS:
        try:
            out[name] = int(getattr(mem, attr, mem.get(attr, 0))
                            if isinstance(mem, dict)
                            else getattr(mem, attr, 0))
        except (AttributeError, TypeError, ValueError):
            out[name] = 0
    return out


def record_executable(site, token, cost=None, mem=None, source="compile"):
    """Store one entry's counts (called by the compile service when it
    makes an entry). Bounded: at most ``_MAX_TOKENS`` distinct tokens and
    ``_PER_SITE`` recent records per site. A token's record holds its
    function's newest entry; fields the new record lacks are kept."""
    if not _state.enabled:
        return None
    rec = {"site": site, "token": token, "source": source,
           "t": time.time()}
    rec.update(_norm_cost(cost))
    rec.update(_norm_mem(mem))
    with _lock:
        if token not in _by_token and len(_by_token) >= _MAX_TOKENS:
            _by_token.pop(next(iter(_by_token)))
        prev = _by_token.get(token)
        if prev is not None:
            merged = dict(prev)
            merged.update({k: v for k, v in rec.items() if v or k in
                           ("site", "token", "source", "t")})
            rec = merged
        _by_token[token] = rec
        dq = _by_site.get(site)
        if dq is None:
            dq = _by_site[site] = deque(maxlen=_PER_SITE)
        dq.append(rec)
        agg = _agg.setdefault(site, {"executables": 0, "flops": 0.0,
                                     "bytes_accessed": 0.0,
                                     "temp_bytes": 0, "output_bytes": 0,
                                     "argument_bytes": 0,
                                     "generated_code_bytes": 0})
        if prev is None:
            agg["executables"] += 1
            for k in ("flops", "bytes_accessed", "temp_bytes",
                      "output_bytes", "argument_bytes",
                      "generated_code_bytes"):
                agg[k] += rec.get(k, 0) or 0
    return rec


def flops_for(token):
    """Counted flops per call of the entry recorded under `token`, or
    None."""
    rec = _by_token.get(token)
    if rec is None:
        return None
    f = rec.get("flops")
    return f if f else None


def latest(site):
    """The most recently recorded entry for `site`, or None."""
    dq = _by_site.get(site)
    return dict(dq[-1]) if dq else None


def records(site=None):
    """Recent executable records (per site, or all sites merged)."""
    if site is not None:
        return [dict(r) for r in _by_site.get(site, ())]
    with _lock:
        return [dict(r) for r in _by_token.values()]


def aggregate():
    """Per-site sums over distinct tokens (the
    ``mxtpu_executables_tracked`` series)."""
    with _lock:
        return {s: dict(a) for s, a in sorted(_agg.items())}


def mfu_xla(flops_per_step, steps_per_sec, devices=1, peak=None,
            device_kind=None):
    """Counted-flops MFU: ``flops/step x steps/s / (peak x devices)``.
    Returns None when the numerator is unknown."""
    if not flops_per_step or not steps_per_sec:
        return None
    if peak is None:
        peak = peak_tflops(device_kind)
    denom = peak * 1e12 * max(1, int(devices or 1))
    if denom <= 0:
        return None
    return flops_per_step * steps_per_sec / denom


def reset():
    """Drop every record (tests)."""
    with _lock:
        _by_token.clear()
        _by_site.clear()
        _agg.clear()


# ------------------------------------------------------------- counting ---

class FlopCount:
    """The counts of one :func:`counting` scope: ``flops`` (aten products
    by ``torch.utils.flop_counter``'s table, plus the hand-written
    kernels' formulas), ``int_ops`` and ``kernels`` ({family: calls})."""

    def __init__(self):
        self.flops = 0
        self.int_ops = 0
        self.kernels = {}

    def cost(self):
        """The counts as ``record_executable``'s ``cost`` dict."""
        return {"flops": float(self.flops), "int ops": float(self.int_ops)}


def _mode_class():
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Counting(TorchDispatchMode):
        """Adds each aten op's table count to ``count.flops`` unless a
        kernel family's plain version is running (``paused``); the
        kernels' dispatch calls :meth:`on_kernel`. Autograd's engine
        threads inherit the mode, so a backward on the card counts too."""

        def __init__(self, count):
            super().__init__()
            self.count = count
            self.paused = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not self.paused:
                fn = flop_registry.get(func._overloadpacket)
                if fn is not None:
                    self.count.flops += int(fn(*args, **kwargs, out_val=out))
            return out

        def on_kernel(self, family, flops, kind):
            c = self.count
            c.kernels[family] = c.kernels.get(family, 0) + 1
            if kind == "int":
                c.int_ops += int(flops)
            else:
                c.flops += int(flops)

    return _Counting


_MODE = []


@contextlib.contextmanager
def counting():
    """Count the flops of the work run in the scope (this thread, and
    autograd's engine threads for its backward); yields the
    :class:`FlopCount`."""
    if not _MODE:
        _MODE.append(_mode_class())
    count = FlopCount()
    with _MODE[0](count):
        yield count
