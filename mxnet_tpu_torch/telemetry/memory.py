"""Device-memory telemetry (counterpart of
``mxnet_tpu/telemetry/memory.py``): live and peak byte gauges, and the
OOM report.

One source per machine, never switched at run time:

* **on a card** (``torch.cuda.is_available()``): ``torch.cuda.
  memory_stats(i)`` of every visible card, ``allocated_bytes.all.
  current`` and ``allocated_bytes.all.peak`` (the caching allocator's
  live tensor bytes and their peak since the last
  ``reset_peak_memory_stats``), source ``memory_stats``, device
  ``gpu:<i>`` as the JAX package names a GPU;
* **on the CPU**, where torch keeps no allocator statistics: the
  process's resident set from ``/proc/self/statm`` under one ``host``
  device (source ``statm_rss``), its peak kept here. It counts the whole
  process (interpreter, libraries, every tensor), an upper bound of the
  framework's bytes.

Samples are taken at trainer step boundaries (every
``MXNET_TPU_TELEMETRY_MEMSAMPLE``-th step, default 1; 0 disables) and at
every ``/metrics`` scrape. :func:`oom_report` puts the sample beside the
entries whose captured pools are largest (:mod:`costs`' ``temp_bytes``:
a CUDA graph has no ``memory_analysis()``, so the output and
generated-code fields of a record are 0).
"""
from __future__ import annotations

import os
import threading

from . import _state, costs as _costs, registry as _registry

__all__ = ["sample", "device_memory", "top_executables", "oom_report",
           "maybe_sample_step", "sample_every"]

_lock = threading.Lock()
_host_peak = 0
_last_sample = None


def sample_every() -> int:
    """Step-boundary sampling period (0 disables step sampling)."""
    try:
        return max(0, int(os.environ.get("MXNET_TPU_TELEMETRY_MEMSAMPLE",
                                         "1")))
    except ValueError:
        return 1


def _rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def device_memory():
    """One record per visible card (or one ``host`` record on the CPU):
    ``{device, platform, live_bytes, peak_bytes, source}``."""
    global _host_peak
    import torch

    if torch.cuda.is_available():
        out = []
        for i in range(torch.cuda.device_count()):
            # memory_stats()'s numbers before its flattening into dotted
            # keys, which costs the hook a step most of its time
            stats = torch.cuda.memory_stats_as_nested_dict(i).get(
                "allocated_bytes", {}).get("all", {})
            live = int(stats.get("current", 0))
            out.append({"device": f"gpu:{i}", "platform": "gpu",
                        "live_bytes": live,
                        "peak_bytes": int(stats.get("peak", live)),
                        "source": "memory_stats"})
        return out
    live = _rss_bytes()
    with _lock:
        _host_peak = max(_host_peak, live)
        peak = _host_peak
    return [{"device": "host", "platform": "cpu", "live_bytes": live,
             "peak_bytes": peak, "source": "statm_rss"}]


def sample(reason="scrape"):
    """Take one sample and publish the live/peak gauges. Returns the
    per-device records (None when telemetry is disabled)."""
    global _last_sample
    if not _state.enabled:
        return None
    recs = device_memory()
    if recs:
        live = _registry.gauge(
            "mxtpu_device_memory_live_bytes",
            "Live device (or host) bytes at the last sample",
            labels=("device",))
        peak = _registry.gauge(
            "mxtpu_device_memory_peak_bytes",
            "Peak device (or host) bytes observed",
            labels=("device",))
        for r in recs:
            live.set(r["live_bytes"], r["device"])
            peak.set(r["peak_bytes"], r["device"])
    _last_sample = {"reason": reason, "devices": recs}
    return recs


def last_sample():
    """The most recent sample (diagnose), or None."""
    return _last_sample


_step_counter = 0


def maybe_sample_step():
    """Step-boundary sampling hook (called by the trainer step timeline);
    honours the ``MXNET_TPU_TELEMETRY_MEMSAMPLE`` period."""
    global _step_counter
    n = sample_every()
    if n == 0:
        return None
    _step_counter += 1
    if _step_counter % n:
        return None
    return sample(reason="step")


def top_executables(k=10):
    """The K entries the compile service made whose ``temp + output +
    generated-code`` bytes are largest: on a card, the captured graphs'
    pools, which stay resident as long as their entries."""
    recs = _costs.records()

    def resident(r):
        return (r.get("temp_bytes", 0) or 0) \
            + (r.get("output_bytes", 0) or 0) \
            + (r.get("generated_code_bytes", 0) or 0)

    recs = [r for r in recs if resident(r) > 0]
    recs.sort(key=resident, reverse=True)
    out = []
    for r in recs[:k]:
        out.append({"site": r["site"], "token": r["token"],
                    "resident_bytes": resident(r),
                    "temp_bytes": r.get("temp_bytes", 0),
                    "output_bytes": r.get("output_bytes", 0),
                    "argument_bytes": r.get("argument_bytes", 0),
                    "generated_code_bytes":
                        r.get("generated_code_bytes", 0)})
    return out


def oom_report(k=10):
    """The OOM post-mortem: the live sample, the top-K resident entries
    and the per-site aggregates."""
    return {"devices": device_memory(),
            "top_executables": top_executables(k),
            "aggregate": _costs.aggregate()}
