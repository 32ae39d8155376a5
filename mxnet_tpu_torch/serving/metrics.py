"""Per-model serving counters (counterpart of
``mxnet_tpu/serving/metrics.py``): latency percentiles over a bounded
ring of recent requests, overall and by priority class, throughput,
bucket census, batch fill ratio, deadline drops and outcomes and
prediction-cache lookups. Rejects, batches and deadline drops also go
to the flight recorder (:mod:`mxnet_tpu_torch.telemetry.flight`). The
profiler's serving tracks and the watchdog's stalled batches are not
ported (``stalled_batches`` stays 0).
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque

from ..telemetry import flight as _flight

__all__ = ["ModelMetrics", "percentile"]

_RING = 8192  # recent-latency window for percentiles


def percentile(values, q):
    """Nearest-rank percentile of a sequence, or None when empty."""
    if not values:
        return None
    xs = sorted(values)
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k]


class ModelMetrics:
    """Thread-safe serving counters for one served model."""

    def __init__(self, model):
        self.model = model
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.rejected = 0        # admission fast-rejects (busy + draining)
        self.failed = 0          # requests failed by a failed batch or stop
        self.stalled = 0         # watchdog-stopped batches (not ported)
        self.batches = 0
        self.rows = 0            # real rows through batches
        self.padded_rows = 0     # padding rows (bucket - rows per batch)
        self.bucket_census = Counter()
        self.deadline_dropped = Counter()   # {"submit": n, "queue": n}
        self.deadline_met = 0    # deadline-carrying requests answered in time
        self.deadline_missed = 0  # answered, but past their deadline
        self.cache_hits = 0
        self.cache_misses = 0
        self.coalesced = 0       # duplicates folded onto a queued leader
        self._lat_ms = deque(maxlen=_RING)
        self._lat_by_class = {}  # priority -> deque ring
        self._t_first = None     # first completion (rate window start)
        self._t_last = None

    def record_submit(self):
        with self._lock:
            self.submitted += 1

    def record_reject(self):
        with self._lock:
            self.rejected += 1
        _flight.rec("serving.reject", self.model)

    def record_fail(self, n=1):
        with self._lock:
            self.failed += n

    def record_complete(self, lat_ms, priority=None):
        now = time.monotonic()
        with self._lock:
            self.completed += 1
            self._lat_ms.append(lat_ms)
            if priority is not None:
                ring = self._lat_by_class.get(priority)
                if ring is None:
                    ring = self._lat_by_class[priority] = \
                        deque(maxlen=_RING // 4)
                ring.append(lat_ms)
            if self._t_first is None:
                self._t_first = now
            self._t_last = now

    def record_deadline_drop(self, where="queue"):
        """A request dropped for its deadline before it took a batch
        slot."""
        with self._lock:
            self.deadline_dropped[where] += 1
        _flight.rec("serving.deadline_drop", self.model, where)

    def record_deadline_outcome(self, met):
        with self._lock:
            if met:
                self.deadline_met += 1
            else:
                self.deadline_missed += 1

    def record_cache(self, hit):
        with self._lock:
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1

    def record_coalesced(self):
        """A content-identical request attached to one already queued or
        running (it never runs a batch of its own)."""
        with self._lock:
            self.coalesced += 1

    def record_batch(self, bucket, rows):
        with self._lock:
            self.batches += 1
            self.rows += rows
            self.padded_rows += bucket - rows
            self.bucket_census[bucket] += 1
        _flight.rec("serving.batch", self.model,
                    f"bucket={bucket} rows={rows}")

    def snapshot(self, **extra):
        """One JSON-able dict: counters, p50/p95/p99 latency over the
        recent window (and p50/p99 by priority class), fill ratio,
        requests per second between the first and last completion, cache
        hit ratio. ``extra`` is merged in."""
        with self._lock:
            lat = list(self._lat_ms)
            by_class = {p: list(r) for p, r in self._lat_by_class.items()}
            padded = self.rows + self.padded_rows
            window = (self._t_last - self._t_first
                      if self._t_first is not None
                      and self._t_last > self._t_first else None)
            cache_total = self.cache_hits + self.cache_misses
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "failed": self.failed,
                "stalled_batches": self.stalled,
                "batches": self.batches,
                "rows": self.rows,
                "padded_rows": self.padded_rows,
                "batch_fill_ratio": self.rows / padded if padded else None,
                "bucket_census": dict(sorted(self.bucket_census.items())),
                "rps": self.completed / window if window else None,
                "deadline_dropped": dict(self.deadline_dropped),
                "deadline_met": self.deadline_met,
                "deadline_missed": self.deadline_missed,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "coalesced": self.coalesced,
                "cache_hit_ratio": self.cache_hits / cache_total
                if cache_total else None,
            }
        for q, key in ((50, "p50_ms"), (95, "p95_ms"), (99, "p99_ms")):
            out[key] = percentile(lat, q)
        if by_class:
            out["by_class"] = {
                p: {"count": len(r), "p50_ms": percentile(r, 50),
                    "p99_ms": percentile(r, 99)}
                for p, r in sorted(by_class.items())}
        out.update(extra)
        return out
