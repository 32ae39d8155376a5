"""Profiler: a chrome-trace dump and aggregate statistics.

Counterpart of ``mxnet_tpu/profiler.py`` (MXNet 1.x
``python/mxnet/profiler.py``): ``set_config``, ``set_state``,
``pause``/``resume``, ``reset``, ``dump``, ``dumps``, the instrumentation
objects (``Domain``, ``Task``, ``Frame``, ``Event``, ``Counter``,
``Marker``, ``scope``) and the ``record_*`` tracks other modules feed:
``record_stall`` (the watchdog), ``record_compile`` and ``record_cache``
(the compile service), ``record_serving`` (served batches) and
``record_skip_step`` (the trainer's non-finite guard).

Host events: ``ndarray._invoke`` records one ``"operator"`` event per
imperative op and ``CachedOp.__call__`` one ``"CachedOp"`` event
(category ``"symbolic"``) per call. Each reads one fast-path flag
(``_REC_IMPERATIVE``, ``_REC_SYMBOLIC``) when the profiler is stopped.

Device events: ``set_config(profile_device=True)`` takes the place of
the JAX package's ``jax.profiler`` trace. ``set_state("run")`` starts a
``torch.profiler`` session with CPU and, on a card, CUDA activity;
``set_state("stop")`` writes its chrome trace to
``<filename>.device/trace.json``. That is torch's chrome-trace format
(kernels under category ``"kernel"``), not the TensorBoard profile the
JAX package writes there. The chrome trace of :func:`dump` loads in
``chrome://tracing`` or Perfetto.
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["set_config", "set_state", "state", "pause", "resume", "dump",
           "dumps", "reset", "trace_info", "device_trace_path", "Domain",
           "Task", "Frame", "Event", "Counter", "Marker", "scope",
           "record_skip_step", "record_stall", "record_cache",
           "record_compile", "record_serving"]

_lock = threading.Lock()
_RECORDING = False       # a session is active and not paused
_REC_IMPERATIVE = False  # fast-path flag read by ndarray._invoke
_REC_SYMBOLIC = False    # fast-path flag read by CachedOp
_session = False         # between set_state('run') and set_state('stop')
_paused = False
_config = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "aggregate_stats": False,
    "continuous_dump": False,
    "dump_period": 1.0,
    "profile_device": False,
    "profile_process": "worker",
}
_events = []     # chrome trace events
_aggregate = {}  # name -> [count, total_us, min_us, max_us]
_epoch = time.perf_counter()
_epoch_mono = time.monotonic()  # the same instant: the cross-clock anchor
_device_prof = None             # the torch.profiler session, when running
_device_trace = None            # the last device trace's path


def _now_us():
    return (time.perf_counter() - _epoch) * 1e6


def _refresh():
    """Recompute the per-category fast-path flags."""
    global _REC_IMPERATIVE, _REC_SYMBOLIC
    _REC_IMPERATIVE = _RECORDING and _config["profile_imperative"]
    _REC_SYMBOLIC = _RECORDING and _config["profile_symbolic"]


def set_config(**kwargs):
    """Configure the profiler (MXNet 1.x ``profiler.set_config``)."""
    unknown = set(kwargs) - set(_config)
    if unknown:
        raise ValueError(f"unknown profiler config keys: {sorted(unknown)}")
    _config.update(kwargs)
    if _config.get("profile_all"):
        for k in ("profile_symbolic", "profile_imperative", "profile_memory",
                  "profile_api", "aggregate_stats"):
            _config[k] = True
    _refresh()


_WARMUP_KERNELS = 256   # a device session's dropped warm-up stage


def _start_device():
    """Start the ``torch.profiler`` session. On a card it records after a
    warm-up stage that it drops: a burst of small kernels and a
    synchronise (a session that recorded from cold lost its first ~50
    kernels on an H100)."""
    global _device_prof
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts, acc_events=True,
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    if cuda:
        x = torch.zeros(1024, device="cuda")
        for _ in range(_WARMUP_KERNELS):
            x.add_(1.0)
        torch.cuda.synchronize()
    prof.step()   # the warm-up stage ends, recording begins
    _device_prof = prof


def _stop_device():
    """End the device session and write its chrome trace."""
    global _device_prof, _device_trace
    prof, _device_prof = _device_prof, None
    prof.stop()
    root = _config["filename"] + ".device"
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "trace.json")
    prof.export_chrome_trace(path)
    _device_trace = path


def device_trace_path():
    """The chrome trace the last ``profile_device`` session wrote, or
    None."""
    return _device_trace


def set_state(state="stop", profile_process="worker"):
    """Start ('run') or stop ('stop') profiling."""
    global _RECORDING, _paused, _session
    if state not in ("run", "stop"):
        raise ValueError("state must be 'run' or 'stop'")
    if state == "run":
        if not _session:
            if _config["profile_device"]:
                _start_device()
            _session = True
        _RECORDING = True
        _paused = False
    else:
        if _session and _device_prof is not None:
            _stop_device()
        _session = False
        _RECORDING = False
        _paused = False
    _refresh()


def state():
    return "run" if _RECORDING else "stop"


def pause(profile_process="worker"):
    """Stop recording without ending the session."""
    global _RECORDING, _paused
    if _session and _RECORDING:
        _RECORDING = False
        _paused = True
        _refresh()


def resume(profile_process="worker"):
    global _RECORDING, _paused
    if _session and _paused:
        _RECORDING = True
        _paused = False
        _refresh()


def reset():
    """Drop every recorded event and the aggregate statistics."""
    with _lock:
        _events.clear()
        _aggregate.clear()


def record_event(name, start_us, dur_us, cat="operator", tid=None,
                 args=None):
    """One complete ('X') chrome-trace event and its aggregate row."""
    ev = {"name": name, "cat": cat, "ph": "X", "pid": os.getpid(),
          "tid": tid if tid is not None else threading.get_ident(),
          "ts": start_us, "dur": dur_us}
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)
        agg = _aggregate.get(name)
        if agg is None:
            _aggregate[name] = [1, dur_us, dur_us, dur_us]
        else:
            agg[0] += 1
            agg[1] += dur_us
            agg[2] = min(agg[2], dur_us)
            agg[3] = max(agg[3], dur_us)


def record_skip_step(total, consecutive):
    """A step the non-finite guard skipped: an instant marker and the
    running total's counter track (only while recording)."""
    if not _RECORDING:
        return
    record_instant("trainer.skip_step", cat="trainer",
                   args={"total": total, "consecutive": consecutive})
    record_counter("trainer.skipped_steps", total)


_stall_count = 0


def record_stall(point, elapsed_s, bundle):
    """A watchdog stall (a point past its deadline, a bundle written): an
    instant marker and the stall counter track, while recording; the
    count itself always advances."""
    global _stall_count
    _stall_count += 1
    if not _RECORDING:
        return
    record_instant("watchdog.stall", cat="watchdog",
                   args={"point": point, "elapsed_s": round(elapsed_s, 3),
                         "bundle": bundle})
    record_counter("watchdog.stalls", _stall_count)


def stall_count():
    """Stalls recorded since the process started."""
    return _stall_count


def record_cache(kind, hits, misses):
    """Hit and miss counter tracks of a cache family."""
    record_counter(f"compile_cache.{kind}.hits", hits)
    record_counter(f"compile_cache.{kind}.misses", misses)


def record_compile(site, dur_ms, source, hits, misses):
    """One compile-service miss (a capture, or an eager first call): a
    complete event over it and the site's cache tracks, while
    recording."""
    if not _RECORDING:
        return
    now = _now_us()
    record_event(f"compile[{site}]", now - dur_ms * 1e3, dur_ms * 1e3,
                 cat="compile", args={"source": source})
    record_cache(f"service.{site}", hits, misses)


def record_serving(model, bucket, rows, dur_ms, queue_depth):
    """One served batch: a complete event over its execution and the
    queue-depth and batch-rows counter tracks, while recording."""
    if not _RECORDING:
        return
    now = _now_us()
    record_event(f"serving[{model}]", now - dur_ms * 1e3, dur_ms * 1e3,
                 cat="serving", args={"bucket": bucket, "rows": rows})
    record_counter(f"serving.{model}.queue_depth", queue_depth)
    record_counter(f"serving.{model}.batch_rows", rows)


def record_instant(name, cat="instant", args=None):
    # dur 0: instants and counters have no duration in the chrome-trace
    # model; consumers read ts/dur/ph as every event's envelope
    ev = {"name": name, "cat": cat, "ph": "i", "pid": os.getpid(),
          "tid": threading.get_ident(), "ts": _now_us(), "dur": 0,
          "s": "p"}
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)


def record_counter(name, value):
    with _lock:
        _events.append({"name": name, "cat": "counter", "ph": "C",
                        "pid": os.getpid(), "tid": 0, "ts": _now_us(),
                        "dur": 0, "args": {name: value}})


def trace_info():
    """The recorded events and the monotonic instant of the profiler's
    clock epoch, so ``telemetry.trace.dump`` can re-base them."""
    with _lock:
        return {"epoch_mono": _epoch_mono, "events": list(_events)}


def dump(finished=True, profile_process="worker"):
    """Write the chrome-trace JSON to ``filename``; ``finished`` also
    stops the session."""
    with _lock:
        payload = {"traceEvents": list(_events), "displayTimeUnit": "ms"}
    with open(_config["filename"], "w") as f:
        json.dump(payload, f)
    if finished:
        set_state("stop")


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """The aggregate statistics as a console table."""
    with _lock:
        rows = [(name, c, tot / 1e3, mn / 1e3, mx / 1e3, tot / c / 1e3)
                for name, (c, tot, mn, mx) in _aggregate.items()]
    key = {"total": 2, "count": 1, "min": 3, "max": 4, "avg": 5,
           "name": 0}[sort_by]
    rows.sort(key=lambda r: r[key], reverse=not ascending)
    lines = ["Profile Statistics:",
             f"{'Name':<40s} {'Count':>8s} {'Total(ms)':>12s} "
             f"{'Min(ms)':>10s} {'Max(ms)':>10s} {'Avg(ms)':>10s}"]
    for name, c, tot, mn, mx, avg in rows:
        lines.append(f"{name[:40]:<40s} {c:>8d} {tot:>12.3f} {mn:>10.3f} "
                     f"{mx:>10.3f} {avg:>10.3f}")
    if reset:
        globals()["reset"]()
    return "\n".join(lines)


# ------------------------------------------------- instrumentation objects --

class Domain:
    """A named profiling domain."""

    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_frame(self, name):
        return Frame(self, name)

    def new_counter(self, name, value=None):
        c = Counter(self, name)
        if value is not None:
            c.set_value(value)
        return c

    def new_marker(self, name):
        return Marker(self, name)

    def __str__(self):
        return self.name


class _Span:
    """A start()/stop() span recorded as one complete event."""

    _cat = "task"

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name
        self._start = None

    def start(self):
        self._start = _now_us()

    def stop(self):
        if self._start is None:
            return
        if _RECORDING:
            record_event(self.name, self._start, _now_us() - self._start,
                         cat=f"{self.domain}:{self._cat}")
        self._start = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def __str__(self):
        return self.name


class Task(_Span):
    _cat = "task"


class Frame(_Span):
    _cat = "frame"


class Event(_Span):
    """A standalone event (no domain)."""

    _cat = "event"

    def __init__(self, name):
        super().__init__("event", name)


class Counter:
    """A counter rendered as a chrome counter track."""

    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        self._value = 0
        if value is not None:
            self.set_value(value)

    def set_value(self, value):
        self._value = value
        if _RECORDING:
            record_counter(self.name, value)

    def increment(self, delta=1):
        self.set_value(self._value + delta)

    def decrement(self, delta=1):
        self.set_value(self._value - delta)

    def __iadd__(self, delta):
        self.increment(delta)
        return self

    def __isub__(self, delta):
        self.decrement(delta)
        return self


class Marker:
    """An instant marker."""

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        if _RECORDING:
            record_instant(self.name, cat=f"{self.domain}:marker")


class scope:
    """A context manager naming the scope ops run in."""

    _current = ""

    def __init__(self, name):
        self.name = name
        self._prev = None

    def __enter__(self):
        self._prev = scope._current
        scope._current = self.name
        return self

    def __exit__(self, *exc):
        scope._current = self._prev
