"""Metrics registry (counterpart of ``mxnet_tpu/telemetry/registry.py``):
counters, gauges and histograms with bounded label sets, rendered as
Prometheus text and JSON.

Two feeding models, as in the JAX package:

* **push**: coarse events update a metric when they happen (the trainer's
  step gauges): one lock and a dict probe, never on the per-op path;
* **pull**: subsystems that keep their own counters (``compile.stats()``,
  ``serving.live_stats()``, the kvstore's op counts, device memory) are
  read by collectors (:mod:`mxnet_tpu_torch.telemetry.export`) at scrape
  time.

Each metric admits at most ``MXNET_TPU_TELEMETRY_MAX_SERIES`` (default
64) label-value combinations; further values collapse into one
``__other__`` series. For the same calls, :func:`render_prometheus`
gives the JAX package's text byte for byte.
"""
from __future__ import annotations

import os
import re
import threading

__all__ = ["counter", "gauge", "histogram", "get", "all_metrics",
           "snapshot", "render_prometheus", "reset",
           "DEFAULT_BUCKETS_MS"]

try:
    MAX_SERIES = int(os.environ.get("MXNET_TPU_TELEMETRY_MAX_SERIES", "64"))
except ValueError:
    MAX_SERIES = 64

# latency-flavoured default buckets (milliseconds)
DEFAULT_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, float("inf"))

_lock = threading.Lock()
_METRICS: dict = {}   # name -> metric

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_OVERFLOW = "__other__"


def _sanitize(name):
    return _NAME_RE.sub("_", str(name))


class _Metric:
    kind = "untyped"

    def __init__(self, name, help="", labels=()):
        self.name = _sanitize(name)
        self.help = help
        self.labels = tuple(labels)
        self._lock = threading.Lock()
        self._series: dict = {}   # label-values tuple -> value

    def _key(self, label_values):
        if len(label_values) != len(self.labels):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labels}, got "
                f"{label_values!r}")
        key = tuple(str(v) for v in label_values)
        if key not in self._series and len(self._series) >= MAX_SERIES:
            key = (_OVERFLOW,) * len(self.labels)
        return key

    def series(self):
        with self._lock:
            return dict(self._series)

    def _snapshot_value(self, v):
        return v

    def snapshot(self):
        return {"kind": self.kind, "help": self.help,
                "labels": list(self.labels),
                "series": [{"labels": dict(zip(self.labels, k)),
                            "value": self._snapshot_value(v)}
                           for k, v in sorted(self.series().items())]}


class Counter(_Metric):
    """Monotone total. ``inc`` is the push path; ``set_total`` is the
    collector seam for totals owned by another subsystem (still rendered
    with TYPE counter — the value is a scrape of a monotone source)."""

    kind = "counter"

    def inc(self, amount=1.0, *label_values):
        key = self._key(label_values)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def set_total(self, value, *label_values):
        key = self._key(label_values)
        with self._lock:
            self._series[key] = float(value)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value, *label_values):
        key = self._key(label_values)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount=1.0, *label_values):
        key = self._key(label_values)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount=1.0, *label_values):
        self.inc(-amount, *label_values)


class Histogram(_Metric):
    """Fixed-bucket cumulative histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name, help="", labels=(), buckets=None):
        super().__init__(name, help, labels)
        bs = tuple(sorted(buckets or DEFAULT_BUCKETS_MS))
        if bs[-1] != float("inf"):
            bs = bs + (float("inf"),)
        self.buckets = bs

    def observe(self, value, *label_values):
        key = self._key(label_values)
        with self._lock:
            rec = self._series.get(key)
            if rec is None:
                rec = self._series[key] = [0, 0.0,
                                           [0] * len(self.buckets)]
            rec[0] += 1
            rec[1] += float(value)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    rec[2][i] += 1

    def _snapshot_value(self, v):
        count, total, per = v
        return {"count": count, "sum": round(total, 6),
                "buckets": {("+Inf" if b == float("inf") else repr(b)): c
                            for b, c in zip(self.buckets, per)}}


def _get_or_create(cls, name, help, labels, **kw):
    name = _sanitize(name)
    with _lock:
        m = _METRICS.get(name)
        if m is None:
            m = _METRICS[name] = cls(name, help=help, labels=labels, **kw)
            return m
    if type(m) is not cls or m.labels != tuple(labels):
        raise ValueError(
            f"metric {name!r} already registered as {m.kind} with labels "
            f"{m.labels}, requested {cls.kind} with {tuple(labels)}")
    return m


def counter(name, help="", labels=()):
    """Get-or-create a :class:`Counter`."""
    return _get_or_create(Counter, name, help, labels)


def gauge(name, help="", labels=()):
    """Get-or-create a :class:`Gauge`."""
    return _get_or_create(Gauge, name, help, labels)


def histogram(name, help="", labels=(), buckets=None):
    """Get-or-create a :class:`Histogram`."""
    return _get_or_create(Histogram, name, help, labels, buckets=buckets)


def get(name):
    """The registered metric named `name`, or None."""
    return _METRICS.get(_sanitize(name))


def all_metrics():
    with _lock:
        return dict(_METRICS)


def reset():
    """Drop every registered metric (tests)."""
    with _lock:
        _METRICS.clear()


def snapshot():
    """JSON-able {name: {kind, help, labels, series}} of every metric.
    The raw registry: :func:`mxnet_tpu_torch.telemetry.export.
    metrics_snapshot` runs the subsystem collectors first."""
    return {name: m.snapshot() for name, m in sorted(all_metrics().items())}


def _esc(v):
    return str(v).replace("\\", r"\\").replace('"', r"\"") \
        .replace("\n", r"\n")


def _fmt(v):
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labelstr(names, values, extra=()):
    parts = [f'{n}="{_esc(v)}"' for n, v in zip(names, values)]
    parts += [f'{n}="{_esc(v)}"' for n, v in extra]
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus():
    """The registry in Prometheus text exposition format (0.0.4).
    Raw: the HTTP endpoints call :func:`mxnet_tpu_torch.telemetry.export.
    render_prometheus`, which runs the collectors first."""
    lines = []
    for name, m in sorted(all_metrics().items()):
        if m.help:
            lines.append(f"# HELP {name} {m.help}")
        lines.append(f"# TYPE {name} {m.kind}")
        for key, v in sorted(m.series().items()):
            if m.kind == "histogram":
                count, total, per = v
                for b, c in zip(m.buckets, per):
                    lines.append(
                        f"{name}_bucket"
                        f"{_labelstr(m.labels, key, [('le', _fmt(b))])}"
                        f" {c}")
                lines.append(f"{name}_sum{_labelstr(m.labels, key)}"
                             f" {_fmt(total)}")
                lines.append(f"{name}_count{_labelstr(m.labels, key)}"
                             f" {count}")
            else:
                lines.append(f"{name}{_labelstr(m.labels, key)} {_fmt(v)}")
    return "\n".join(lines) + "\n"
