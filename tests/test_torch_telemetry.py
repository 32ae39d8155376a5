"""The port's telemetry stack (mxnet_tpu_torch/telemetry/) on the CPU,
held against the JAX package's functions: the counterparts of
tests/test_telemetry.py's local cases.

* the registry: for the same calls, the Prometheus text of both
  packages' registries is equal byte for byte, and so are their JSON
  snapshots; label bounds and kind mismatches behave alike;
* the peak table (the JAX rows and the H100 rows ahead of them),
  ``BENCH_PEAK_TFLOPS`` and ``mfu_xla``'s arithmetic, equal to the JAX
  functions' (exact);
* the step record: the keys of the JAX trainer's ``step_report()``, the
  phases plus ``other`` summing to the duration (within the rounding of
  each to 1e-3 ms), an aborted step leaving no record, the history ring
  at its cap;
* the memory records' schema and the OOM report's;
* flop counts: a Dense-only MLP step against JAX's ``cost_analysis()``
  flops for the same step (the port counts the matrix products and the
  optimizer kernel's elementwise formula; XLA counts every elementwise op
  besides, a gap held between 0 and 8 flops per activation and parameter
  element), and a 2-layer attention classifier step against its analytic
  count exactly (the plain K3 and K3-bwd and K2 adding their formulas);
* ``GET /metrics`` and ``/metrics.json`` of the serving front end against
  ``ModelServer.stats()`` and ``compile.stats()`` (requests, batches and
  rows exact, p99 to rel 0.01 of its rounding), the standalone
  ``MetricsServer``, and ``describe()``.
"""
import json
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import (build_classifier, classifier_step_flops, make_task,
                        random_params)
from mxnet_tpu.parallel import DeviceMesh as JaxMesh
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.telemetry import costs as jcosts
from mxnet_tpu.telemetry import memory as jmemory
from mxnet_tpu.telemetry import registry as jregistry
from mxnet_tpu.telemetry import steps as jsteps
from mxnet_tpu_torch import compile as C
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer
from mxnet_tpu_torch.telemetry import costs, memory, registry, steps

CPU = mx.cpu()


def _lines(text, prefix):
    """The lines of a Prometheus text that belong to metrics named
    ``prefix*`` (other tests register other metrics)."""
    return [l for l in text.splitlines()
            if l.split(" ", 3)[2 if l.startswith("#") else 0]
            .startswith(prefix)]


def _feed(reg, prefix):
    c = reg.counter(prefix + "total", "a counter", labels=("site",))
    c.inc(2, "a")
    c.inc(1, "a")
    c.inc(5, 'b "quoted"\\back\nslash')
    c.set_total(7.25, "c")
    g = reg.gauge(prefix + "gauge", "a gauge")
    g.set(2.5)
    g.inc(0.125)
    g2 = reg.gauge(prefix + "gauge2", labels=("a", "b"))
    g2.set(1e20, "x", "y")
    g2.dec(3, "x", "z")
    h = reg.histogram(prefix + "hist", "a histogram", labels=("k",))
    for v in (0.5, 3.0, 700.0, 1e9):
        h.observe(v, "v")
    h2 = reg.histogram(prefix + "hist2", "custom buckets",
                       buckets=(1, 10, 100))
    h2.observe(5)
    h2.observe(float("inf"))


def test_registry_renders_the_jax_text_byte_for_byte():
    prefix = "mxtpu_t_port_reg_"
    _feed(registry, prefix)
    _feed(jregistry, prefix)
    got = _lines(registry.render_prometheus(), prefix)
    want = _lines(jregistry.render_prometheus(), prefix)
    assert got and "\n".join(got) == "\n".join(want)
    assert any(l.endswith(" +Inf") or '{le="+Inf"}' in l for l in got)
    snap = {k: v for k, v in registry.snapshot().items()
            if k.startswith(prefix)}
    jsnap = {k: v for k, v in jregistry.snapshot().items()
             if k.startswith(prefix)}
    assert json.dumps(snap, sort_keys=True) == \
        json.dumps(jsnap, sort_keys=True)


def test_registry_label_bounds_and_kind_mismatch_like_jax():
    assert registry.MAX_SERIES == jregistry.MAX_SERIES
    for reg in (registry, jregistry):
        c = reg.counter("mxtpu_t_port_card_total", "bounded", labels=("k",))
        for i in range(reg.MAX_SERIES + 50):
            c.inc(1, f"v{i}")
        series = c.series()
        assert len(series) == reg.MAX_SERIES + 1
        assert series[("__other__",)] == 50
        with pytest.raises(ValueError, match="takes labels"):
            c.inc(1)
        reg.counter("mxtpu_t_port_kind_total", "x")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("mxtpu_t_port_kind_total", "x")
        with pytest.raises(ValueError, match="already registered"):
            reg.counter("mxtpu_t_port_kind_total", "x", labels=("a",))
    assert registry.get("mxtpu_t_port_card_total") is not None


def test_peak_table_with_the_h100_rows_and_the_override(monkeypatch):
    for kind, _ in jcosts.PEAK_TFLOPS_TABLE:
        assert costs.nominal_peak_tflops(kind) == \
            jcosts.nominal_peak_tflops(kind)
    for kind in ("TPU v5p chip", "TPU v5 lite", "unknown accelerator",
                 "cpu"):
        assert costs.nominal_peak_tflops(kind) == \
            jcosts.nominal_peak_tflops(kind)
    assert costs.nominal_peak_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert costs.nominal_peak_tflops("NVIDIA H100 PCIe") == 756.5
    assert costs.PEAK_TFLOPS_TABLE[:2] == (("h100 pcie", 756.5),
                                           ("h100", 989.4))
    assert costs.PEAK_TFLOPS_TABLE[2:] == jcosts.PEAK_TFLOPS_TABLE
    # no card here: the kind is "cpu"
    assert costs.nominal_peak_tflops() == costs.CPU_FALLBACK_TFLOPS
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "123.5")
    assert costs.peak_tflops() == 123.5 == jcosts.peak_tflops()
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "0")
    assert costs.peak_tflops("NVIDIA H100 80GB HBM3") == 989.4


@pytest.mark.parametrize("args", [
    (1e12, 100.0, 1, 200.0), (1e12, 100.0, 2, 200.0),
    (3.7e11, 12.5, 1, 989.4), (None, 100.0, 1, 200.0), (1e12, 0.0, 1, 1.0),
    (5e9, 3.0, 0, 989.4)])
def test_mfu_xla_arithmetic_equals_jax(args):
    flops, rate, devices, peak = args
    assert costs.mfu_xla(flops, rate, devices=devices, peak=peak) == \
        jcosts.mfu_xla(flops, rate, devices=devices, peak=peak)
    if flops and rate:
        assert costs.mfu_xla(flops, rate, devices=1, peak=peak) == \
            pytest.approx(flops * rate / (peak * 1e12))


def _mlp(pkg, x, **kw):
    """Dense(64, relu) -> Dense(8) under "sgd" with momentum, L2 loss."""
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(64, activation="relu", in_units=32),
            pkg.gluon.nn.Dense(8, in_units=64))
    if pkg is mx:
        net.initialize(mx.init.Xavier(), ctx=CPU)
        mesh = DeviceMesh({"dp": 1}, devices=[CPU])
        return ShardedTrainer(net, mx.gluon.loss.L2Loss(), "sgd",
                              {"learning_rate": 0.01, "momentum": 0.9},
                              mesh=mesh, **kw)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(x))
    return JaxTrainer(net, jmx.gluon.loss.L2Loss(), "sgd",
                      {"learning_rate": 0.01, "momentum": 0.9},
                      mesh=JaxMesh({"dp": 1}), **kw)


def _xy(batch=16):
    rs = np.random.RandomState(0)
    return (rs.randn(batch, 32).astype(np.float32),
            rs.randn(batch, 8).astype(np.float32))


def test_step_record_has_the_jax_keys_and_phases():
    x, y = _xy()
    st, jst = _mlp(mx, x), _mlp(jmx, x)
    for _ in range(2):
        st.step(x, y)
        jst.step(jmx.nd.array(x), jmx.nd.array(y))
    rec, jrec = st.step_report(), jst.step_report()
    assert set(rec) == set(jrec) == {"step", "duration_ms", "phases",
                                     "t_wall", "flops", "mfu_xla"}
    assert set(rec["phases"]) == set(jrec["phases"]) == \
        set(steps.PHASES) | {"other"}
    assert steps.PHASES == jsteps.PHASES
    assert rec["step"] == 2 and rec["phases"]["compute"] > 0
    assert rec["phases"]["optimizer"] == 0.0
    assert sum(rec["phases"].values()) == pytest.approx(
        rec["duration_ms"], abs=7e-3)
    assert rec["flops"] == costs.flops_for(st._step_fn._token_key) > 0
    assert rec["mfu_xla"] == round(costs.mfu_xla(
        rec["flops"], 1e3 / rec["duration_ms"]), 5)
    snap = telemetry.metrics_snapshot()
    assert snap["mxtpu_step_time_ms"]["series"][0]["value"] > 0
    assert snap["mxtpu_step_flops"]["series"][0]["value"] == rec["flops"]
    assert any(s["labels"]["phase"] == "compute"
               for s in snap["mxtpu_step_phase_ms"]["series"])
    prev = telemetry.set_enabled(False)
    try:
        st.step(x, y)
        assert st.step_report()["step"] == 2   # no record with it off
    finally:
        telemetry.set_enabled(prev)


def test_an_aborted_step_leaves_no_record_at_the_ring_cap():
    """A step that raises abandons its record: below the cap the history
    does not grow, at the cap the newest record is unchanged; the next
    step lands (tests/test_telemetry.py:184-228)."""
    steps.reset()
    x, y = _xy()
    st = _mlp(mx, x)
    st.step(x, y)
    before = len(steps.history())
    with pytest.raises(RuntimeError):
        st.step(x[:, :5], y)   # a batch the first Dense cannot take
    assert len(steps.history()) == before
    template = steps.last()
    cap = steps._HIST.maxlen
    while len(steps._HIST) < cap:
        steps._HIST.append(dict(template, step=len(steps._HIST)))
    last = steps.last()
    with pytest.raises(RuntimeError):
        st.step(x[:, :5], y)
    assert steps.last() == last
    st.step(x, y)
    assert len(steps.history()) == cap and steps.last() != last
    assert steps.history(2)[-1] == steps.last()
    steps.reset()
    assert steps.last() is None and steps.history() == []


def test_memory_records_have_the_jax_schema():
    recs = memory.sample(reason="test")
    jrecs = jmemory.device_memory()
    assert recs and jrecs
    assert set(recs[0]) == set(jrecs[0]) == {"device", "platform",
                                             "live_bytes", "peak_bytes",
                                             "source"}
    assert recs[0]["source"] == "statm_rss" and recs[0]["device"] == "host"
    assert 0 < recs[0]["live_bytes"] <= recs[0]["peak_bytes"]
    assert memory.last_sample()["reason"] == "test"
    # an entry with counted costs appears in the report's aggregate
    x, y = _xy()
    _mlp(mx, x).step(x, y)
    rep, jrep = memory.oom_report(), jmemory.oom_report()
    assert set(rep) == set(jrep)
    assert "trainer" in rep["aggregate"]
    assert set(rep["aggregate"]["trainer"]) == \
        set(jcosts.aggregate().get("trainer", rep["aggregate"]["trainer"]))
    # the CPU captures no pool: no resident entry to list
    assert memory.top_executables() == []
    snap = telemetry.metrics_snapshot()
    assert snap["mxtpu_device_memory_live_bytes"]["series"][0]["labels"] \
        == {"device": "host"}


def test_mlp_step_flops_against_jax_cost_analysis():
    """The port counts the matrix products (forward 2·B·(32·64 + 64·8),
    backward twice that but the first layer's input gradient) and K1's
    7 per parameter element; XLA's ``cost_analysis()`` counts every
    elementwise op too (the bias adds, ReLU and its mask, the loss, the
    update's arithmetic), so its count is larger by 0 to 8 flops per
    element of the activations and parameters."""
    batch = 16
    x, y = _xy(batch)
    st, jst = _mlp(mx, x), _mlp(jmx, x)
    st.step(x, y)
    jst.step(jmx.nd.array(x), jmx.nd.array(y))
    got = st.step_report()["flops"]
    want = jst.step_report()["flops"]
    products = 2 * batch * (32 * 64 + 64 * 8)
    products += 2 * products - 2 * batch * 32 * 64
    params = 32 * 64 + 64 + 64 * 8 + 8
    assert got == products + 7 * params
    elements = batch * (64 + 8) + params
    assert 0 < want - got <= 8 * elements, (got, want)


SMALL = {"vocab": 100, "units": 64, "hidden": 128, "heads": 4, "layers": 2,
         "seq_len": 16, "num_classes": 4}


def test_attention_classifier_step_flops_equal_the_analytic_count():
    x, y = make_task(8, SMALL["seq_len"], SMALL["vocab"],
                     SMALL["num_classes"], seed=5)
    weights = random_params(SMALL, seed=0)
    clf = build_classifier(mx, SMALL)
    clf.initialize(ctx=CPU)
    load_jax_params(clf, weights)
    st = ShardedTrainer(clf, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                        {"learning_rate": 1e-3},
                        mesh=DeviceMesh({"dp": 1}, devices=[CPU]))
    st.step(x, y)
    want = classifier_step_flops(SMALL, 8)
    assert st.step_report()["flops"] == want
    entry = st._step_fn.stats()["entries"][0]
    assert entry["flops"] == want and entry["int_ops"] == 0
    # a replay's flops are the capture's
    st.step(x, y)
    assert st.step_report()["flops"] == want
    # the same count without running the step
    assert st.aot_lower(x, y).flops == want


def _scrape(url, path="/metrics"):
    with urllib.request.urlopen(url + path, timeout=10) as resp:
        return resp.read().decode(), resp.headers.get("Content-Type")


def _metric_value(text, name, **labels):
    for line in text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            if all(f'{k}="{v}"' in line for k, v in labels.items()):
                return float(line.rsplit(" ", 1)[1])
    return None


def test_http_metrics_agree_with_stats():
    """``GET /metrics`` on a live front end: the serving series equal
    ``ModelServer.stats()`` (requests, batches, rows, queue depth; p99
    to rel 0.01), the compile series ``compile.stats()``, the memory
    series present; ``/metrics.json`` parses and carries them too."""
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(8, activation="relu", in_units=6),
            mx.gluon.nn.Dense(3, in_units=8))
    net.initialize(mx.init.Xavier(), ctx=CPU)
    container = serving.ModelContainer()
    container.add_block("tel_port", net, example_shape=(6,), buckets=(2, 4),
                        ctx=CPU)
    server = serving.ModelServer(container, max_wait_ms=1.0).start()
    front = None
    try:
        server.warmup()
        front = serving.HttpFrontEnd(server).start()
        rows = np.random.RandomState(0).randn(1, 6).astype(np.float32)
        for _ in range(12):
            server.predict("tel_port", rows, timeout=10.0)
        text, ctype = _scrape(front.url)
        assert ctype.startswith("text/plain; version=0.0.4")
        st = server.stats()["models"]["tel_port"]
        assert _metric_value(text, "mxtpu_serving_requests_total",
                             model="tel_port",
                             outcome="completed") == st["completed"] == 12
        assert _metric_value(text, "mxtpu_serving_batches_total",
                             model="tel_port") == st["batches"]
        assert _metric_value(text, "mxtpu_serving_rows_total",
                             model="tel_port") == st["rows"] == 12
        assert _metric_value(text, "mxtpu_serving_queue_depth",
                             model="tel_port") == st["queue_depth"]
        assert _metric_value(text, "mxtpu_serving_latency_ms",
                             model="tel_port", quantile="p99") == \
            pytest.approx(st["p99_ms"], rel=0.01)
        cst = C.stats()["serving"]
        for name, key in (("mxtpu_compile_cache_hits_total", "hits"),
                          ("mxtpu_compile_cache_misses_total", "misses"),
                          ("mxtpu_compile_replays_total", "replays")):
            assert _metric_value(text, name, site="serving") == cst[key]
        assert _metric_value(text, "mxtpu_compile_ms_total",
                             site="serving") == pytest.approx(
                                 cst["compile_ms"], rel=0.01)
        assert _metric_value(text, "mxtpu_device_memory_live_bytes",
                             device="host") > 0
        jtext, jtype = _scrape(front.url, "/metrics.json")
        snap = json.loads(jtext)
        assert jtype.startswith("application/json")
        assert "mxtpu_serving_requests_total" in snap
    finally:
        if front is not None:
            front.close()
        server.drain(timeout=10.0)
        server.stop()


def test_standalone_metrics_server_and_describe():
    srv = telemetry.MetricsServer(port=0).start()
    try:
        text, ctype = _scrape(srv.url)
        assert ctype.startswith("text/plain")
        assert "mxtpu_flight_ring_size" in text
        assert "mxtpu_trace_ring_size" in text
        health, _ = _scrape(srv.url, "/healthz")
        assert json.loads(health)["status"] == "ok"
        snap = json.loads(_scrape(srv.url, "/metrics.json")[0])
        assert "mxtpu_flight_ring_size" in snap
    finally:
        srv.close()
    d = telemetry.describe()
    jd = jmx.telemetry.describe()
    assert set(d) == set(jd)
    assert d["flight_ring"] == telemetry.flight.size()
    for name in ("registry", "costs", "memory", "steps", "trace", "export",
                 "MetricsServer", "metrics_snapshot", "render_prometheus",
                 "register_collector"):
        assert name in telemetry.__all__ and hasattr(telemetry, name)
    assert set(telemetry.__all__) == set(jmx.telemetry.__all__) - {"fleet"}


def test_a_raising_collector_is_counted_and_the_scrape_goes_on():
    calls = []

    def broken():
        calls.append(1)
        raise RuntimeError("collector failure")

    telemetry.register_collector("t_port_broken", broken)
    try:
        text = telemetry.render_prometheus()
        assert calls and _metric_value(text, "mxtpu_collector_errors") >= 1
        assert "mxtpu_flight_ring_size" in text
    finally:
        assert telemetry.export.unregister_collector("t_port_broken")
    telemetry.render_prometheus()
    assert telemetry.export.collect() == []


def test_telemetry_off_counts_no_flops():
    """With telemetry off a new entry records no flops (the count runs
    only when it is on)."""
    x, y = _xy()
    prev = telemetry.set_enabled(False)
    try:
        st = _mlp(mx, x)
        st.step(x, y)
        assert "flops" not in st._step_fn.stats()["entries"][0]
        assert costs.flops_for(st._step_fn._token_key) is None
    finally:
        telemetry.set_enabled(prev)
