"""Span tracer with propagated context (counterpart of
``mxnet_tpu/telemetry/trace.py``): per-request and per-step timelines.

* **Serving requests** carry a request id from the HTTP front end (its
  ``X-Request-Id``, or one minted there) or one minted at ``submit``
  through the batcher's queue, the staging of the padded batch, the
  bucket's replay and the response, giving five phases per request::

      queue_wait     submit -> popped by the batch collector
      batch_collect  the rows copied into the bucket's pinned host batch
      h2d            the batch's copy to the card started on the side stream
      compute        the bucket's run (a graph replay on a card)
      respond        output slicing and the futures' fulfilment

  ``ServingFuture.breakdown()`` and the HTTP response (``phases``,
  ``request_id``, the ``X-Request-Id`` header) carry them.
* **Trainer steps**: every finished step of the
  :mod:`~mxnet_tpu_torch.telemetry.steps` timeline commits one span
  keyed ``(generation, rank, step)`` with its phases as children.
* **Ad-hoc spans** (:func:`span`) nest through a per-thread stack and
  inherit the thread's propagated context (:func:`context`).

Committed spans live in a bounded ring (``MXNET_TPU_TRACE``, default
2048; 0 disables tracing). Off, every hook is one check
(:func:`enabled`); on, the cost is per request, batch or step, never per
op. :func:`dump` writes this process's spans and flight-recorder tail as
a Chrome-trace ``trace.json`` (Perfetto, ``chrome://tracing``).

Not ported: the profiler's events in a dump (``include_profiler=True``
raises: ``profiler.py`` waits for ROADMAP item A11) and the gang's
telemetry shards (``run_dir=`` raises: ``fleet.py`` waits for item A12).
:func:`merged_events` over shards handed to it is pure and is ported.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque

from . import _state

__all__ = ["enabled", "configure", "size", "new_request_id", "coords",
           "context", "set_context", "get_context", "span", "commit",
           "request_begin", "RequestTrace", "REQUEST_PHASES",
           "step_span", "tail", "counts", "clear", "dump", "last_dump",
           "merged_events", "describe"]

#: the serving request phase vocabulary, in pipeline order
REQUEST_PHASES = ("queue_wait", "batch_collect", "h2d", "compute",
                  "respond")

try:
    _N = int(os.environ.get("MXNET_TPU_TRACE", "2048"))
except ValueError:
    _N = 2048
_N = max(0, _N)

_ring = deque(maxlen=(_N or 1))
_seq = itertools.count()
_ids = itertools.count(1)
_counts: dict = {}
_counts_lock = threading.Lock()
_tls = threading.local()
_last_dump = None


def enabled() -> bool:
    """True when spans are being recorded (telemetry on AND ring > 0).
    The one check every tracing hook performs before doing any work."""
    return _state.enabled and _N > 0


def configure(size):
    """Resize the span ring at runtime (0 disables tracing). Returns the
    previous size."""
    global _N, _ring
    prev = _N
    _N = max(0, int(size))
    _ring = deque(maxlen=(_N or 1))
    with _counts_lock:
        _counts.clear()
    return prev


def size():
    """Ring capacity (``MXNET_TPU_TRACE``; 0 = tracing disabled)."""
    return _N


def coords():
    """(rank, generation) gang coordinates of this process — 0/0 outside
    a supervised gang (``MXTPU_WORKER_ID`` / ``MXTPU_GANG_GENERATION``
    are exported by the supervisor / launcher)."""
    try:
        rank = int(os.environ.get("MXTPU_WORKER_ID", "0") or 0)
    except ValueError:
        rank = 0
    try:
        gen = int(os.environ.get("MXTPU_GANG_GENERATION", "0") or 0)
    except ValueError:
        gen = 0
    return rank, gen


def new_request_id():
    """A process-unique request id (pid-prefixed atomic counter:
    ``itertools.count`` is C-implemented and atomic under the GIL, so
    concurrent submits never collide)."""
    return f"{os.getpid():x}-{next(_ids):x}"


# ------------------------------------------------------- context plumbing --

def set_context(trace_id):
    """Bind `trace_id` as this thread's propagated trace context (spans
    and requests created on this thread inherit it). Returns the
    previous binding."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace_id
    return prev


def get_context():
    """This thread's propagated trace id, or None."""
    return getattr(_tls, "trace", None)


class context:
    """``with trace.context(request_id): ...``: scoped propagation (the
    HTTP front end wraps each handled request in one)."""

    def __init__(self, trace_id):
        self.trace_id = trace_id
        self._prev = None

    def __enter__(self):
        self._prev = set_context(self.trace_id)
        return self.trace_id

    def __exit__(self, *exc):
        _tls.trace = self._prev


# ------------------------------------------------------------- committing --

def commit(name, t0_mono, dur_ms, *, kind="span", trace_id=None,
           parent=None, lane=None, attrs=None):
    """Append one finished span to the ring (no-op when tracing is off).
    Returns the span id (None when off)."""
    if not enabled():
        return None
    sid = next(_seq)
    rec = {"seq": sid, "name": name, "kind": kind,
           "trace": trace_id if trace_id is not None else get_context(),
           "parent": parent,
           "t0": round(float(t0_mono), 6),
           "dur_ms": round(float(dur_ms), 4),
           "lane": int(lane) if lane is not None
           else (threading.get_ident() % 100000),
           "attrs": attrs or None}
    _ring.append(rec)
    with _counts_lock:
        _counts[kind] = _counts.get(kind, 0) + 1
    return sid


class span:
    """Measure a nested span: ``with trace.span("io.h2d"): ...``.
    Nesting is tracked per thread — an inner span's ``parent`` is the
    enclosing span's id, and both inherit the thread's trace context."""

    def __init__(self, name, kind="span", **attrs):
        self.name = name
        self.kind = kind
        self.attrs = attrs
        self.span_id = None
        self._t0 = None

    def __enter__(self):
        if enabled():
            self._t0 = time.monotonic()
            stack = getattr(_tls, "stack", None)
            if stack is None:
                stack = _tls.stack = []
            # claim the id up front so children can reference it
            self.span_id = next(_seq)
            stack.append(self.span_id)
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return
        stack = getattr(_tls, "stack", ())
        if stack and stack[-1] == self.span_id:
            stack.pop()
        parent = stack[-1] if stack else None
        if not enabled():
            return
        rec = {"seq": self.span_id, "name": self.name, "kind": self.kind,
               "trace": get_context(), "parent": parent,
               "t0": round(self._t0, 6),
               "dur_ms": round((time.monotonic() - self._t0) * 1e3, 4),
               "lane": threading.get_ident() % 100000,
               "attrs": self.attrs or None}
        _ring.append(rec)
        with _counts_lock:
            _counts[self.kind] = _counts.get(self.kind, 0) + 1


# -------------------------------------------------------- serving requests --

_lane = itertools.count()


class RequestTrace:
    """One serving request's propagated context: the batcher stamps
    monotonic marks as the request moves through the pipeline and
    :meth:`finish` turns them into the five-phase breakdown + committed
    spans. Marks are written by one thread at a time (submit thread ->
    collector -> runner), so no lock is needed."""

    __slots__ = ("request_id", "model", "rows", "marks", "breakdown",
                 "_lane")

    def __init__(self, request_id, model, rows=1):
        self.request_id = request_id
        self.model = model
        self.rows = rows
        self.marks = {"submit": time.monotonic()}
        self.breakdown = None
        self._lane = 1000 + next(_lane) % 256

    def mark(self, name, t=None):
        """Stamp pipeline mark `name` (submit / collected / assembled /
        staged / run_begin / run_end)."""
        self.marks[name] = time.monotonic() if t is None else t

    def _phase_bounds(self):
        m = self.marks
        return (("queue_wait", m.get("submit"), m.get("collected")),
                ("batch_collect", m.get("collected"), m.get("assembled")),
                ("h2d", m.get("assembled"), m.get("staged")),
                ("compute", m.get("run_begin"), m.get("run_end")),
                ("respond", m.get("run_end"), m.get("done")))

    def finish(self, error=None, bucket=None):
        """Close the request: compute the phase breakdown, commit the
        parent ``request`` span + one child span per measured phase."""
        self.mark("done")
        bd = {"request_id": self.request_id, "model": self.model,
              "rows": self.rows,
              "total_ms": round((self.marks["done"]
                                 - self.marks["submit"]) * 1e3, 4)}
        if error is not None:
            bd["error"] = str(error)
        if bucket is not None:
            bd["bucket"] = bucket
        for name, a, b in self._phase_bounds():
            bd[f"{name}_ms"] = round(max(0.0, (b - a) * 1e3), 4) \
                if (a is not None and b is not None) else None
        self.breakdown = bd
        if not enabled():
            return bd
        parent = commit(f"request[{self.model}]", self.marks["submit"],
                        bd["total_ms"], kind="request",
                        trace_id=self.request_id, lane=self._lane,
                        attrs={k: v for k, v in bd.items()
                               if k not in ("request_id", "model")})
        for name, a, b in self._phase_bounds():
            if a is None or b is None:
                continue
            commit(name, a, max(0.0, (b - a) * 1e3), kind="phase",
                   trace_id=self.request_id, parent=parent,
                   lane=self._lane)
        return bd


def request_begin(model, rows=1, request_id=None):
    """Open a :class:`RequestTrace` for one serving submit (None when
    tracing is off). The id is the thread's propagated context (the
    HTTP front end's ``X-Request-Id``) when bound, else freshly
    minted."""
    if not enabled():
        return None
    rid = request_id or get_context() or new_request_id()
    return RequestTrace(rid, model, rows=rows)


# ----------------------------------------------------------- trainer steps --

def step_span(rec, t0_mono):
    """Commit one trainer step as a span keyed ``(generation, rank,
    step)`` with its phase children laid out in pipeline order (called
    by :func:`mxnet_tpu_torch.telemetry.steps.end_step`)."""
    if not enabled():
        return
    rank, gen = coords()
    trace_id = f"step-g{gen}-r{rank}-{rec['step']}"
    lane = 500 + (rank % 100)
    parent = commit("trainer.step", t0_mono, rec["duration_ms"],
                    kind="step", trace_id=trace_id, lane=lane,
                    attrs={"step": rec["step"], "rank": rank,
                           "generation": gen,
                           "phases": dict(rec["phases"])})
    # the phase split is accrued (durations, not timestamps); lay the
    # children out sequentially in the order they actually execute
    t = t0_mono
    for name in ("data_wait", "h2d", "compute", "optimizer", "sync",
                 "other"):
        ms = rec["phases"].get(name, 0.0)
        if ms <= 0.0:
            continue
        commit(name, t, ms, kind="phase", trace_id=trace_id,
               parent=parent, lane=lane)
        t += ms / 1e3


# ------------------------------------------------------------- inspection --

def tail(n=None):
    """The last `n` (default all retained) committed spans, oldest
    first, as JSON-able dicts."""
    items = list(_ring)
    if n is not None:
        items = items[-int(n):]
    return [dict(r) for r in items]


def counts():
    """Process-lifetime committed-span totals per kind."""
    with _counts_lock:
        return dict(_counts)


def clear():
    """Drop retained spans and counts (tests)."""
    _ring.clear()
    with _counts_lock:
        _counts.clear()


def describe():
    """Knobs and census."""
    return {"ring": _N, "enabled": enabled(), "spans": counts(),
            "retained": len(_ring), "last_dump": _last_dump}


def last_dump():
    """Path of the most recent :func:`dump` in this process, or None."""
    return _last_dump


# ------------------------------------------------------- chrome-trace dump --

def _span_event(rec, rank, offset, base_wall):
    ts = (rec["t0"] + offset - base_wall) * 1e6
    ev = {"name": rec["name"], "cat": f"trace.{rec['kind']}",
          "ph": "X", "pid": rank, "tid": rec.get("lane", 0),
          "ts": round(ts, 3), "dur": round(rec["dur_ms"] * 1e3, 3)}
    args = dict(rec.get("attrs") or {})
    if rec.get("trace"):
        args["trace"] = rec["trace"]
    if args:
        ev["args"] = args
    return ev


def _flight_event(rec, rank, offset, base_wall):
    ts = (rec["t_mono"] + offset - base_wall) * 1e6
    ev = {"name": rec["kind"], "cat": "flight", "ph": "i", "s": "p",
          "pid": rank, "tid": 0, "ts": round(ts, 3), "dur": 0}
    if rec.get("point") or rec.get("label") is not None:
        ev["args"] = {"point": rec.get("point"),
                      "label": rec.get("label")}
    return ev


def merged_events(shards):
    """Fold the rank shards' spans + flight tails into one list of
    chrome-trace events with per-rank lanes (``pid`` = rank) and clocks
    aligned via each shard's (t_wall, t_mono) heartbeat pair. Within a
    rank the alignment is a constant offset, so per-rank event order is
    preserved exactly (monotonicity test-asserted)."""
    return _merged(shards)[0]


def _merged(shards):
    lanes = []
    base_wall = None
    for rank in sorted(shards):
        sh = shards[rank]
        offset = float(sh["t_wall"]) - float(sh["t_mono"])
        spans = [r for r in sh.get("spans") or []
                 if isinstance(r, dict) and "t0" in r and "dur_ms" in r]
        flights = [r for r in sh.get("flight") or []
                   if isinstance(r, dict) and "t_mono" in r]
        for r in spans:
            wall = r["t0"] + offset
            base_wall = wall if base_wall is None else min(base_wall, wall)
        for r in flights:
            wall = r["t_mono"] + offset
            base_wall = wall if base_wall is None else min(base_wall, wall)
        lanes.append((rank, offset, spans, flights, sh))
    events = []
    if base_wall is None:
        base_wall = 0.0
    for rank, offset, spans, flights, sh in lanes:
        label = f"rank {rank}"
        if sh.get("generation"):
            label += f" (gen {sh['generation']})"
        events.append({"name": "process_name", "ph": "M", "pid": rank,
                       "tid": 0, "ts": 0, "dur": 0,
                       "cat": "__metadata", "args": {"name": label}})
        events.append({"name": "process_sort_index", "ph": "M",
                       "pid": rank, "tid": 0, "ts": 0, "dur": 0,
                       "cat": "__metadata", "args": {"sort_index": rank}})
        for r in spans:
            events.append(_span_event(r, rank, offset, base_wall))
        for r in flights:
            events.append(_flight_event(r, rank, offset, base_wall))
    return events, base_wall


def _local_shard():
    """This process's spans and flight tail shaped like a fleet shard."""
    from . import flight as _flight

    rank, gen = coords()
    return rank, {"rank": rank, "generation": gen,
                  "t_wall": time.time(), "t_mono": time.monotonic(),
                  "spans": tail(), "flight": _flight.tail()}


def dump(path="trace.json", run_dir=None, include_profiler=False):
    """Write this process's spans and flight-recorder tail as a
    Chrome-trace ``trace.json`` (one lane per rank, timestamps from the
    first event). Returns the written path.

    ``include_profiler=True`` (the JAX package's default: the profiler's
    events on the same timeline) and ``run_dir`` (every rank's telemetry
    shard) raise :class:`~mxnet_tpu_torch.base.MXNetError`: the profiler
    and the fleet shards are not ported."""
    global _last_dump
    from ..base import MXNetError

    if include_profiler:
        raise MXNetError("trace.dump(include_profiler=True): the profiler "
                         "(profiler.py) is not ported to mxnet_tpu_torch "
                         "yet; see ROADMAP.md item A11")
    if run_dir is not None:
        raise MXNetError("trace.dump(run_dir=...): the fleet's telemetry "
                         "shards (telemetry/fleet.py) are not ported to "
                         "mxnet_tpu_torch yet; see ROADMAP.md item A12")
    rank, local = _local_shard()
    events, _ = _merged({rank: local})
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(payload, f)
    _last_dump = os.path.abspath(path)
    return _last_dump
