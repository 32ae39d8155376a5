"""Per-model serving counters (counterpart of
``mxnet_tpu/serving/metrics.py``): latency percentiles over a bounded
ring of recent requests, throughput, bucket census and batch fill ratio.
"""
from __future__ import annotations

import threading
import time
from collections import Counter, deque

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
        self.batches = 0
        self.rows = 0            # real rows through batches
        self.padded_rows = 0     # padding rows (bucket - rows per batch)
        self.bucket_census = Counter()
        self._lat_ms = deque(maxlen=_RING)
        self._t_first = None     # first completion (rate window start)
        self._t_last = None

    def record_submit(self):
        with self._lock:
            self.submitted += 1

    def record_reject(self):
        with self._lock:
            self.rejected += 1

    def record_fail(self, n=1):
        with self._lock:
            self.failed += n

    def record_complete(self, lat_ms):
        now = time.monotonic()
        with self._lock:
            self.completed += 1
            self._lat_ms.append(lat_ms)
            if self._t_first is None:
                self._t_first = now
            self._t_last = now

    def record_batch(self, bucket, rows):
        with self._lock:
            self.batches += 1
            self.rows += rows
            self.padded_rows += bucket - rows
            self.bucket_census[bucket] += 1

    def snapshot(self, **extra):
        """One JSON-able dict: counters, p50/p95/p99 latency over the
        recent window, fill ratio, requests per second between
        the first and last completion. ``extra`` is merged in."""
        with self._lock:
            lat = list(self._lat_ms)
            padded = self.rows + self.padded_rows
            window = (self._t_last - self._t_first
                      if self._t_first is not None
                      and self._t_last > self._t_first else None)
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "failed": self.failed,
                "batches": self.batches,
                "rows": self.rows,
                "padded_rows": self.padded_rows,
                "batch_fill_ratio": self.rows / padded if padded else None,
                "bucket_census": dict(sorted(self.bucket_census.items())),
                "rps": self.completed / window if window else None,
            }
        for q, key in ((50, "p50_ms"), (95, "p95_ms"), (99, "p99_ms")):
            out[key] = percentile(lat, q)
        out.update(extra)
        return out
