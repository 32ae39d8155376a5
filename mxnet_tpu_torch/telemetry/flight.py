"""Flight recorder (counterpart of ``mxnet_tpu/telemetry/flight.py``): an
always-on, constant-memory ring of the last N structured runtime events.

Recorded event kinds in the port:

    ``serving.reject``              admission fast-reject
    ``serving.batch``               served batch
    ``serving.deadline_drop``       a request dropped for its deadline
    ``modelbus.*``                  live-weight-bus lifecycle (publish,
                                    apply, reject, rollback, torn_skip,
                                    skip_nonfinite)

Memory contract: the ring is a preallocated list of fixed slot lists
written in place, so a long-running process holds exactly
``MXNET_TPU_FLIGHT`` (default 1024; 0 disables) events.

Lock-light: writers claim slots through an atomic counter
(``itertools.count``) and write their slot without a lock; :func:`tail`
drops a slot whose sequence number a racing writer left torn.
"""
from __future__ import annotations

import itertools
import os
import time

from . import _state

__all__ = ["rec", "tail", "counts", "size", "clear"]

try:
    _N = int(os.environ.get("MXNET_TPU_FLIGHT", "1024"))
except ValueError:
    _N = 1024
_N = max(0, _N)

# slot layout: [seq, t_mono, t_wall, kind, point, label]
_ring = [[-1, 0.0, 0.0, "", "", None] for _ in range(_N)]
_seq = itertools.count()
_counts: dict = {}


def rec(kind, point="", label=None):
    """Record one event (no-op when telemetry is disabled or the ring
    size is 0). ``label`` may be any short printable value — it lands in
    crash bundles verbatim."""
    if not _state.enabled or _N == 0:
        return
    i = next(_seq)
    slot = _ring[i % _N]
    slot[0] = -1  # invalidate while torn
    slot[1] = time.monotonic()
    slot[2] = time.time()
    slot[3] = kind
    slot[4] = point
    slot[5] = label
    slot[0] = i   # publish
    # lossy-tolerable totals: a racing increment may drop one count, the
    # ring itself is exact (seq-claimed slots) — not worth a lock on the
    # every-event hot path
    _counts[kind] = _counts.get(kind, 0) + 1  # concur: atomic


def tail(n=None):
    """The last ``n`` (default: all retained) events as JSON-able dicts,
    oldest first. Torn or empty slots are skipped."""
    events = []
    for slot in _ring:
        seq, t_mono, t_wall, kind, point, label = slot
        if seq < 0:
            continue
        events.append({"seq": seq, "t_mono": round(t_mono, 6),
                       "t_wall": round(t_wall, 6), "kind": kind,
                       "point": point, "label": label})
    events.sort(key=lambda e: e["seq"])
    if n is not None:
        events = events[-int(n):]
    return events


def counts():
    """Process-lifetime event totals per kind (feeds the
    ``mxtpu_flight_events_total`` metric series)."""
    return dict(_counts)


def size():
    """Ring capacity (``MXNET_TPU_FLIGHT``; 0 = disabled)."""
    return _N


def clear():
    """Drop all retained events and counts (tests)."""
    for slot in _ring:
        slot[0] = -1
    _counts.clear()
