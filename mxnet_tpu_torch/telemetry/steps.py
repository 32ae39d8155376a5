"""Per-step phase timeline (counterpart of
``mxnet_tpu/telemetry/steps.py``): data-wait / h2d / compute / optimizer
/ sync.

One record per ``ShardedTrainer.step``:

    ``data_wait``  time the consumer blocked on the input pipeline
                   (``PrefetchingIter`` and ``ImageRecordIter`` report it
                   into the next step's record);
    ``h2d``        the batch's placement on the device (``_put_batch``);
    ``compute``    the step call: a graph replay (or the eager first
                   call and the capture) on a card, the plain call on the
                   CPU. Forward, backward and the optimizer run in it;
    ``optimizer``  a separate optimizer call's time (0 for the
                   ShardedTrainer step, whose update is inside it; kept so
                   the grammar is the JAX package's);
    ``sync``       host reads after the step (the nan-guard's flag, which
                   waits for the device; a dist kvstore's pull waiting
                   for its reductions).

Each finished step publishes ``mxtpu_step_time_ms``,
``mxtpu_step_phase_ms{phase}``, a duration histogram and a step counter,
and, when the compile service counted the step's flops
(:mod:`costs`), ``mxtpu_step_flops`` and ``mxtpu_step_mfu_xla``; then
its span (:func:`trace.step_span`), ``step.begin``/``step.end`` flight
events and a memory sample. ``ShardedTrainer.step_report()`` returns the
record.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from . import _state, costs as _costs, flight as _flight
from . import registry as _registry

__all__ = ["PHASES", "begin_step", "phase", "end_step", "abort", "last",
           "history", "reset"]

PHASES = ("data_wait", "h2d", "compute", "optimizer", "sync")

_lock = threading.Lock()
_HIST = deque(maxlen=256)
_cur = None
_pending: dict = {}   # phases measured before the step opened (data_wait)


def begin_step(step):
    """Open the record for `step` (folds in pending pre-step phases)."""
    global _cur
    if not _state.enabled:
        return
    phases = dict.fromkeys(PHASES, 0.0)
    with _lock:
        phases.update(_pending)
        _pending.clear()
    _cur = {"step": int(step), "t0": time.monotonic(), "phases": phases}
    _flight.rec("step.begin", "trainer.step", int(step))


def phase(name, ms):
    """Accrue `ms` into phase `name` of the open step — or, with no step
    open (the prefetcher measuring data-wait between steps), into the
    next one."""
    if not _state.enabled:
        return
    cur = _cur
    if cur is not None:
        cur["phases"][name] = cur["phases"].get(name, 0.0) + ms
    else:
        with _lock:
            _pending[name] = _pending.get(name, 0.0) + ms


def abort():
    """Discard the open record (the step raised); its partial phases must
    not skew the timeline."""
    global _cur
    _cur = None


def end_step(flops=None, devices=1, device_kind=None):
    """Close the open record: total duration, phase splits, and MFU when
    `flops` (per call, counted at capture) is known.
    Publishes the step gauges and returns the record (None when no step
    is open)."""
    global _cur
    cur = _cur
    if cur is None:
        return None
    _cur = None
    dur_ms = (time.monotonic() - cur["t0"]) * 1e3
    rec = {"step": cur["step"], "duration_ms": round(dur_ms, 3),
           "phases": {k: round(v, 3) for k, v in cur["phases"].items()},
           "t_wall": time.time()}
    accounted = sum(cur["phases"].values())
    rec["phases"]["other"] = round(max(0.0, dur_ms - accounted), 3)
    if flops:
        rec["flops"] = flops
        mfu = _costs.mfu_xla(flops, 1e3 / dur_ms if dur_ms > 0 else 0.0,
                             devices=devices, device_kind=device_kind)
        if mfu is not None:
            rec["mfu_xla"] = round(mfu, 5)
    _HIST.append(rec)
    _registry.counter("mxtpu_train_steps_total",
                      "Trainer steps completed").inc()
    _registry.gauge("mxtpu_step_time_ms",
                    "Duration of the last trainer step").set(dur_ms)
    ph = _registry.gauge("mxtpu_step_phase_ms",
                         "Phase split of the last trainer step",
                         labels=("phase",))
    for k, v in rec["phases"].items():
        ph.set(v, k)
    _registry.histogram("mxtpu_step_time_ms_hist",
                        "Trainer step duration distribution").observe(
                            dur_ms)
    if rec.get("mfu_xla") is not None:
        _registry.gauge(
            "mxtpu_step_mfu_xla",
            "Counted-flops MFU of the last step (flops over the "
            "per-device-kind peak)").set(rec["mfu_xla"])
        _registry.gauge("mxtpu_step_flops",
                        "Counted flops per step").set(flops)
    # the step's span, keyed (generation, rank, step)
    from . import trace as _trace

    _trace.step_span(rec, cur["t0"])
    _flight.rec("step.end", "trainer.step",
                f"step {rec['step']} {rec['duration_ms']}ms")
    from . import memory as _memory

    _memory.maybe_sample_step()
    return rec


def last():
    """The most recent finished step record, or None."""
    return dict(_HIST[-1]) if _HIST else None


def history(n=None):
    """The last `n` (default all retained) step records, oldest first."""
    items = list(_HIST)
    if n is not None:
        items = items[-int(n):]
    return [dict(r) for r in items]


def reset():
    """Drop records and pending phases (tests)."""
    global _cur
    with _lock:
        _pending.clear()
    _cur = None
    _HIST.clear()
