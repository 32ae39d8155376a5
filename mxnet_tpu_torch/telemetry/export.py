"""Metrics export (counterpart of ``mxnet_tpu/telemetry/export.py``):
the subsystem collectors and the ``/metrics`` endpoints.

A scrape runs every registered collector (:func:`collect`): each copies
counters a subsystem already keeps into the
:mod:`~mxnet_tpu_torch.telemetry.registry`, which then renders
Prometheus text (:func:`render_prometheus`) or JSON
(:func:`metrics_snapshot`). Collectors find their subsystems through
``sys.modules``: a module never imported has no traffic to report, and a
scrape never imports the serving stack into a process.

The collectors of the port: ``compile`` (``compile.stats()``: the JAX
package's series, with 0 for its disk-cache hits and load time, which
the port does not have, and the captures and replays beside them),
``serving`` (``serving.live_stats()``, with the rows served as
``mxtpu_serving_rows_total`` beside the JAX package's series),
``kvstore`` (its op counts and
the bucket pipelines' reductions), ``memory`` (:mod:`memory`'s sample
and :mod:`costs`' per-site sums), ``flight``, ``trace``, ``modelbus``,
``watchdog`` (the stalls the profiler counted, and whether a deadline is
configured) and ``preempt`` (whether a drain is requested). The JAX
package's ``gang`` collector is absent: its subsystem (``elastic.py``)
is not ported (ROADMAP.md item A11).

Exposure: the serving :class:`~mxnet_tpu_torch.serving.http.HttpFrontEnd`
answers ``GET /metrics`` (Prometheus text) and ``GET /metrics.json``;
:class:`MetricsServer` is the standalone endpoint for processes without
a front end (trainers): ``MetricsServer(port=9100).start()`` serves
``/metrics``, ``/metrics.json`` and ``/healthz``.
"""
from __future__ import annotations

import json
import logging
import sys
import threading

from . import costs as _costs, flight as _flight, memory as _memory
from . import registry as _registry
from . import trace as _trace

__all__ = ["register_collector", "unregister_collector", "collect",
           "metrics_snapshot", "render_prometheus", "render_json",
           "MetricsServer", "PROMETHEUS_CONTENT_TYPE"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_log = logging.getLogger(__name__)
_lock = threading.Lock()
_COLLECTORS = []           # (name, fn)
_defaults_installed = False


def register_collector(name, fn):
    """Register a scrape-time collector (replaces a previous one of the
    same name)."""
    with _lock:
        for i, (n, _) in enumerate(_COLLECTORS):
            if n == name:
                _COLLECTORS[i] = (name, fn)
                return
        _COLLECTORS.append((name, fn))


def unregister_collector(name):
    """Remove the collector registered as `name` (tests / fleet
    teardown). Returns True when one was removed."""
    with _lock:
        for i, (n, _) in enumerate(_COLLECTORS):
            if n == name:
                del _COLLECTORS[i]
                return True
    return False


def collect():
    """Run every collector. A collector that raises is counted (the
    ``mxtpu_collector_errors`` gauge) and the scrape goes on with the
    others: one broken subsystem does not take the endpoint down.
    Returns the names of the collectors that raised."""
    _ensure_defaults()
    errors = []
    with _lock:
        items = list(_COLLECTORS)
    for name, fn in items:
        try:
            fn()
        except Exception:
            _log.warning("telemetry collector %r raised", name,
                         exc_info=True)
            errors.append(name)
    if errors:
        _registry.gauge("mxtpu_collector_errors",
                        "Collectors that raised at the last scrape").set(
                            len(errors))
    return errors


def metrics_snapshot():
    """Collect, then return the registry as a JSON-able dict."""
    collect()
    return _registry.snapshot()


def render_prometheus():
    """Collect, then render the registry in Prometheus text format."""
    collect()
    return _registry.render_prometheus()


def render_json():
    return json.dumps(metrics_snapshot(), sort_keys=True)


# ---------------------------------------------------- default collectors ---

def _collect_compile():
    mod = sys.modules.get("mxnet_tpu_torch.compile")
    if mod is None:
        return
    hits = _registry.counter("mxtpu_compile_cache_hits_total",
                             "Compile-service in-memory cache hits",
                             labels=("site",))
    misses = _registry.counter("mxtpu_compile_cache_misses_total",
                               "Compile-service cache misses",
                               labels=("site",))
    disk = _registry.counter("mxtpu_compile_cache_disk_hits_total",
                             "Compile-service persistent-cache hits",
                             labels=("site",))
    compiles = _registry.counter("mxtpu_compile_compiles_total",
                                 "Entries made (captures among them)",
                                 labels=("site",))
    cms = _registry.counter("mxtpu_compile_ms_total",
                            "Milliseconds spent making entries",
                            labels=("site",))
    lms = _registry.counter("mxtpu_compile_load_ms_total",
                            "Milliseconds spent loading cached "
                            "executables", labels=("site",))
    caps = _registry.counter("mxtpu_compile_captures_total",
                             "CUDA graphs captured", labels=("site",))
    reps = _registry.counter("mxtpu_compile_replays_total",
                             "CUDA graph replays", labels=("site",))
    for site, st in mod.stats().items():
        hits.set_total(st["hits"], site)
        misses.set_total(st["misses"], site)
        disk.set_total(0, site)   # no disk cache: a graph does not persist
        compiles.set_total(st["compiles"], site)
        cms.set_total(st["compile_ms"], site)
        lms.set_total(0, site)
        caps.set_total(st["captures"], site)
        reps.set_total(st["replays"], site)


def _collect_serving():
    mod = sys.modules.get("mxnet_tpu_torch.serving.server")
    if mod is None:
        return
    req = _registry.counter("mxtpu_serving_requests_total",
                            "Serving requests by outcome",
                            labels=("model", "outcome"))
    rps = _registry.gauge("mxtpu_serving_rps",
                          "Completion-window requests/s", labels=("model",))
    lat = _registry.gauge("mxtpu_serving_latency_ms",
                          "Recent-window latency percentiles",
                          labels=("model", "quantile"))
    depth = _registry.gauge("mxtpu_serving_queue_depth",
                            "Rows waiting for a batch", labels=("model",))
    fill = _registry.gauge("mxtpu_serving_batch_fill_ratio",
                           "Real rows / padded rows", labels=("model",))
    batches = _registry.counter("mxtpu_serving_batches_total",
                                "Compiled batches executed",
                                labels=("model",))
    rows = _registry.counter("mxtpu_serving_rows_total",
                             "Request rows served (padding not counted)",
                             labels=("model",))
    stalls = _registry.counter("mxtpu_serving_stalled_batches_total",
                               "Batches killed by a watchdog stall",
                               labels=("model",))
    dl_drop = _registry.counter(
        "mxtpu_serving_deadline_dropped_total",
        "Requests dropped before a batch slot: provably unable to meet "
        "their deadline (where: submit|queue)", labels=("model", "where"))
    dl_out = _registry.counter(
        "mxtpu_serving_deadline_outcomes_total",
        "Deadline-carrying requests answered, by outcome",
        labels=("model", "outcome"))
    cache_req = _registry.counter(
        "mxtpu_serving_cache_requests_total",
        "Prediction-cache lookups by outcome",
        labels=("model", "outcome"))
    cache_ratio = _registry.gauge(
        "mxtpu_serving_cache_hit_ratio",
        "Prediction-cache hits / lookups (lifetime)", labels=("model",))
    coalesced = _registry.counter(
        "mxtpu_serving_coalesced_total",
        "Content-identical requests folded onto an in-flight leader",
        labels=("model",))
    class_lat = _registry.gauge(
        "mxtpu_serving_class_latency_ms",
        "Recent-window latency percentiles by QoS class",
        labels=("model", "class", "quantile"))
    for srv in mod.live_stats():
        for model, m in srv.get("models", {}).items():
            for outcome in ("submitted", "completed", "rejected",
                            "failed"):
                req.set_total(m.get(outcome, 0), model, outcome)
            if m.get("rps") is not None:
                rps.set(m["rps"], model)
            for q in ("p50", "p95", "p99"):
                v = m.get(f"{q}_ms")
                if v is not None:
                    lat.set(v, model, q)
            depth.set(m.get("queue_depth", 0), model)
            if m.get("batch_fill_ratio") is not None:
                fill.set(m["batch_fill_ratio"], model)
            batches.set_total(m.get("batches", 0), model)
            rows.set_total(m.get("rows", 0), model)
            stalls.set_total(m.get("stalled_batches", 0), model)
            for where, n in (m.get("deadline_dropped") or {}).items():
                dl_drop.set_total(n, model, where)
            dl_out.set_total(m.get("deadline_met", 0), model, "met")
            dl_out.set_total(m.get("deadline_missed", 0), model,
                             "missed")
            cache_req.set_total(m.get("cache_hits", 0), model, "hit")
            cache_req.set_total(m.get("cache_misses", 0), model, "miss")
            if m.get("cache_hit_ratio") is not None:
                cache_ratio.set(m["cache_hit_ratio"], model)
            coalesced.set_total(m.get("coalesced", 0), model)
            for klass, cm in (m.get("by_class") or {}).items():
                for q in ("p50", "p99"):
                    v = cm.get(f"{q}_ms")
                    if v is not None:
                        class_lat.set(v, model, klass, q)


def _collect_watchdog():
    prof = sys.modules.get("mxnet_tpu_torch.profiler")
    if prof is not None:
        _registry.counter(
            "mxtpu_watchdog_stalls_total",
            "Deadline-blown sync points (crash bundles written)"
        ).set_total(prof.stall_count())
    wd = sys.modules.get("mxnet_tpu_torch.watchdog")
    if wd is not None:
        _registry.gauge("mxtpu_watchdog_enabled",
                        "1 when a watchdog deadline config is installed"
                        ).set(1.0 if wd.enabled() else 0.0)


def _collect_preempt():
    mod = sys.modules.get("mxnet_tpu_torch.preempt")
    if mod is None:
        return
    _registry.gauge("mxtpu_preempt_drain_requested",
                    "1 once a preemption drain has been requested").set(
                        1.0 if mod.requested() else 0.0)


def _collect_kvstore():
    mod = sys.modules.get("mxnet_tpu_torch.kvstore.kvstore")
    if mod is None:
        return
    ops = _registry.counter("mxtpu_kvstore_ops_total",
                            "KVStore operations", labels=("op",))
    for op, n in mod.OP_COUNTS.items():
        ops.set_total(n, op)
    bmod = sys.modules.get("mxnet_tpu_torch.kvstore.buckets")
    if bmod is None:
        return
    cs = bmod.comm_stats()
    if not cs["pipelines"]:
        return
    _registry.counter("mxtpu_kvstore_fused_collectives_total",
                      "Fused bucket collectives dispatched").set_total(
                          cs["fused"])
    _registry.counter("mxtpu_kvstore_bucket_bytes_total",
                      "Bytes moved through fused bucket collectives"
                      ).set_total(cs["bytes"])
    _registry.gauge("mxtpu_kvstore_pending_buckets",
                    "Bucket reductions currently in flight "
                    "(dispatched, unresolved)").set(cs["pending"])


def _collect_memory():
    _memory.sample(reason="scrape")
    tracked = _registry.gauge("mxtpu_executables_tracked",
                              "Distinct compiled functions with counted "
                              "costs", labels=("site",))
    temp = _registry.gauge("mxtpu_executable_temp_bytes",
                           "Sum of captured graph-pool bytes over tracked "
                           "functions", labels=("site",))
    for site, agg in _costs.aggregate().items():
        tracked.set(agg["executables"], site)
        temp.set(agg["temp_bytes"], site)


def _collect_flight():
    ev = _registry.counter("mxtpu_flight_events_total",
                           "Flight-recorder events", labels=("kind",))
    for kind, n in _flight.counts().items():
        ev.set_total(n, kind)
    _registry.gauge("mxtpu_flight_ring_size",
                    "Flight-recorder capacity (0 = disabled)").set(
                        _flight.size())


def _collect_trace():
    spans = _registry.counter("mxtpu_trace_spans_total",
                              "Committed trace spans", labels=("kind",))
    for kind, n in _trace.counts().items():
        spans.set_total(n, kind)
    _registry.gauge("mxtpu_trace_ring_size",
                    "Span-ring capacity (0 = tracing disabled)").set(
                        _trace.size())


def _collect_modelbus():
    mod = sys.modules.get("mxnet_tpu_torch.modelbus")
    if mod is None:
        return
    st = mod.stats()
    for key, help_ in (
            ("published", "Bus update records published"),
            ("applied", "Bus versions applied to live served models"),
            ("rejected", "Bus versions rejected + quarantined by a "
                         "subscriber (CRC / census / finiteness)"),
            ("rollbacks", "Rollback re-publications of a good version "
                          "after a quarantined head"),
            ("torn_skips", "Torn/partial bus records skipped "
                           "(warn-once latched)"),
            ("publish_skipped_nonfinite", "Updates the publisher's "
                                          "finite gate refused")):
        _registry.counter(f"mxtpu_modelbus_{key}_total",
                          help_).set_total(st.get(key, 0))
    ver = _registry.gauge("mxtpu_serving_model_version",
                          "Model-bus version pinned by each served "
                          "model (0 = load-time weights)",
                          labels=("model",))
    srv = sys.modules.get("mxnet_tpu_torch.serving.server")
    if srv is not None:
        for s in srv.live_servers():
            for m in s.container:
                ver.set(m.version, m.name)
    age = _registry.gauge("mxtpu_serving_model_age_steps",
                          "Bounded staleness: newest published trainer "
                          "step minus the applied one, per watcher",
                          labels=("worker",))
    for w in mod.live_watchers():
        age.set(w.age_steps(), w.worker)


def _ensure_defaults():
    global _defaults_installed
    if _defaults_installed:
        return
    _defaults_installed = True
    register_collector("compile", _collect_compile)
    register_collector("serving", _collect_serving)
    register_collector("kvstore", _collect_kvstore)
    register_collector("memory", _collect_memory)
    register_collector("flight", _collect_flight)
    register_collector("trace", _collect_trace)
    register_collector("modelbus", _collect_modelbus)
    register_collector("watchdog", _collect_watchdog)
    register_collector("preempt", _collect_preempt)


# ------------------------------------------------------ standalone server ---

class MetricsServer:
    """A loopback HTTP endpoint serving ``/metrics`` (Prometheus text),
    ``/metrics.json`` and ``/healthz`` for processes that do not run the
    serving front end (trainers). ``port=0`` picks a free one."""

    def __init__(self, host="127.0.0.1", port=0):
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            server_version = "mxtt-metrics/0.1"

            def log_message(self, *args):
                pass

            def _send(self, code, body, ctype):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path in ("/metrics", "/"):
                    self._send(200, render_prometheus(),
                               PROMETHEUS_CONTENT_TYPE)
                elif self.path == "/metrics.json":
                    self._send(200, render_json(), "application/json")
                elif self.path == "/healthz":
                    self._send(200, '{"status": "ok"}',
                               "application/json")
                else:
                    self._send(404, f'{{"error": "no route '
                                    f'{self.path}"}}', "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def url(self):
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1}, daemon=True,
                name="mxtt-metrics-http")
            self._thread.start()
        return self

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
