"""Telemetry (counterpart of ``mxnet_tpu/telemetry``): the one
observability seam of the port.

* :mod:`~mxnet_tpu_torch.telemetry.registry`: counters, gauges and
  histograms with bounded label sets, rendered as Prometheus text and
  JSON;
* :mod:`~mxnet_tpu_torch.telemetry.export`: the subsystem collectors,
  :class:`~mxnet_tpu_torch.telemetry.export.MetricsServer`, and the
  rendering behind the serving front end's ``GET /metrics``;
* :mod:`~mxnet_tpu_torch.telemetry.flight`: the always-on,
  constant-memory flight recorder;
* :mod:`~mxnet_tpu_torch.telemetry.memory`: live and peak device-memory
  gauges (``torch.cuda.memory_stats`` on a card, the resident set on the
  CPU) and the OOM report;
* :mod:`~mxnet_tpu_torch.telemetry.costs`: the flops counted when the
  compile service makes an entry, the peak table, and ``mfu_xla``;
* :mod:`~mxnet_tpu_torch.telemetry.steps`: the per-step phase timeline
  (data-wait / h2d / compute / optimizer / sync);
* :mod:`~mxnet_tpu_torch.telemetry.trace`: spans, propagated request ids
  through the serving pipeline (five phases per request), step spans and
  the Chrome-trace dump.

The JAX package's ``fleet`` (per-rank shards, the straggler verdict)
waits for ROADMAP.md item A12.

Knobs, as in the JAX package: ``MXNET_TPU_TELEMETRY=0`` turns push
instrumentation off (:func:`set_enabled` at run time);
``MXNET_TPU_FLIGHT`` sizes the flight ring; ``MXNET_TPU_TRACE`` the span
ring; ``MXNET_TPU_TELEMETRY_MEMSAMPLE`` paces step-boundary memory
samples; ``MXNET_TPU_TELEMETRY_MAX_SERIES`` bounds a metric's label
sets. Off, every hook is one module-global check; on, nothing runs per
op: the hooks are per step, per batch and per request, and the flop
count runs once per compiled entry.
"""
from __future__ import annotations

from . import _state, costs, export, flight, memory, registry, steps, trace
from ._state import set_enabled
from .export import (MetricsServer, metrics_snapshot, register_collector,
                     render_prometheus)

__all__ = ["enabled", "set_enabled", "describe", "registry", "flight",
           "costs", "memory", "steps", "export", "trace",
           "MetricsServer", "metrics_snapshot", "render_prometheus",
           "register_collector"]


def enabled() -> bool:
    """True when push instrumentation is active."""
    return _state.enabled


def describe():
    """Effective knobs and state as a plain dict."""
    import os

    return {
        "enabled": _state.enabled,
        "env": os.environ.get("MXNET_TPU_TELEMETRY", "<unset>"),
        "flight_ring": flight.size(),
        "flight_events": sum(flight.counts().values()),
        "metrics": len(registry.all_metrics()),
        "memory_sample_every": memory.sample_every(),
        "executables_tracked": {s: a["executables"]
                                for s, a in costs.aggregate().items()},
        "last_step": steps.last(),
        "trace": trace.describe(),
    }
