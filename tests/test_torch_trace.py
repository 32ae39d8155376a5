"""The port's span tracer (mxnet_tpu_torch/telemetry/trace.py) on the
CPU: the counterparts of tests/test_trace.py's local cases, held against
the JAX package's functions where the two take the same input.

* span nesting through the per-thread stack, the propagated context,
  the bounded ring and ``configure``;
* request ids unique under concurrent minting and concurrent submits,
  one id per request end to end;
* the five phases of a served request through the batcher
  (``ServingFuture.breakdown()``, the request span and its five phase
  children) and through the HTTP front end (``X-Request-Id`` honoured or
  minted and echoed, ``phases`` in the body), with the JAX front end's
  response keys;
* ``merged_events`` over the same synthetic shards equal to the JAX
  function's output (exact: a pure function of its input), per-rank
  order kept, and the local ``dump`` a valid Chrome trace;
* a trainer step's span keyed ``(generation, rank, step)`` with its
  phases as children.

The JAX tests of ``fleet`` shards, straggler detection and the gang drill
wait for ROADMAP.md item A12 (``telemetry/fleet.py`` is not ported):
``dump(run_dir=...)`` raises. ``dump(include_profiler=True)`` puts the
profiler's recorded events on the dump's timeline.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.telemetry import trace as jtrace
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer
from mxnet_tpu_torch.telemetry import trace

CPU = mx.cpu()
PHASES = trace.REQUEST_PHASES


def small_server(pkg, name, buckets=(2,)):
    net = pkg.gluon.nn.Dense(4, in_units=6)
    cont = pkg.serving.ModelContainer()
    if pkg is mx:
        net.initialize(mx.init.Xavier(), ctx=CPU)
        cont.add_block(name, net, example_shape=(6,), buckets=buckets,
                       ctx=CPU)
    else:
        net.initialize(jmx.init.Xavier())
        net(jmx.nd.zeros((2, 6)))
        cont.add_block(name, net, example_shape=(6,), buckets=buckets)
    srv = pkg.serving.ModelServer(cont, max_wait_ms=1.0).start()
    srv.warmup()
    return srv


def test_span_nesting_and_context():
    trace.clear()
    with trace.context("job-1"):
        with trace.span("outer") as outer:
            with trace.span("inner"):
                time.sleep(0.002)
    spans = {s["name"]: s for s in trace.tail()}
    assert spans["inner"]["parent"] == outer.span_id
    assert spans["outer"]["parent"] is None
    assert spans["inner"]["trace"] == spans["outer"]["trace"] == "job-1"
    assert spans["outer"]["dur_ms"] >= spans["inner"]["dur_ms"] > 0
    assert trace.get_context() is None
    assert trace.REQUEST_PHASES == jtrace.REQUEST_PHASES
    assert set(trace.__all__) == set(jtrace.__all__)


def test_span_ring_bounded_and_configure():
    prev = trace.configure(16)
    try:
        for i in range(50):
            trace.commit(f"s{i}", time.monotonic(), 0.1)
        assert len(trace.tail()) == 16 and trace.size() == 16
        assert trace.tail()[-1]["name"] == "s49"
        assert trace.counts() == {"span": 50}
        trace.configure(0)
        assert not trace.enabled()
        assert trace.commit("off", time.monotonic(), 0.1) is None
        assert trace.tail() == []
        assert trace.request_begin("m") is None
    finally:
        trace.configure(prev)
    assert trace.describe()["ring"] == prev


def test_request_ids_unique_under_concurrent_submits():
    ids, lock = set(), threading.Lock()

    def mint(n):
        got = [trace.new_request_id() for _ in range(n)]
        with lock:
            ids.update(got)

    threads = [threading.Thread(target=mint, args=(200,)) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive()
    assert len(ids) == 8 * 200

    srv = small_server(mx, "uniq")
    try:
        futs, flock = [], threading.Lock()

        def submit_some():
            for _ in range(10):
                f = srv.submit("uniq", np.zeros((1, 6), np.float32))
                with flock:
                    futs.append(f)

        workers = [threading.Thread(target=submit_some) for _ in range(4)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30.0)
            assert not w.is_alive()
        for f in futs:
            f.result(10.0)
        rids = [f.request_id for f in futs]
        assert None not in rids and len(set(rids)) == len(rids) == 40
        assert all(f.breakdown()["request_id"] == f.request_id
                   for f in futs)
    finally:
        srv.drain(timeout=10.0)
        srv.stop()


def test_serving_request_has_five_phases():
    trace.clear()
    srv = small_server(mx, "fp")
    try:
        fut = srv.submit("fp", np.zeros((1, 6), np.float32))
        fut.result(10.0)
        bd = fut.breakdown()
        assert bd is not None and bd["request_id"] == fut.request_id
        assert bd["bucket"] == 2 and bd["rows"] == 1
        for k in PHASES:
            assert isinstance(bd[f"{k}_ms"], float) and bd[f"{k}_ms"] >= 0
        assert sum(bd[f"{k}_ms"] for k in PHASES) <= bd["total_ms"] + 1e-3
        spans = trace.tail()
        req = [s for s in spans if s["kind"] == "request"
               and s["trace"] == fut.request_id]
        assert len(req) == 1 and req[0]["attrs"]["rows"] == 1
        children = [s for s in spans if s["kind"] == "phase"
                    and s["trace"] == fut.request_id]
        assert sorted(c["name"] for c in children) == sorted(PHASES)
        assert all(c["parent"] == req[0]["seq"] for c in children)
    finally:
        srv.drain(timeout=10.0)
        srv.stop()


def _post(url, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps({"data": np.zeros((1, 6)).tolist()}).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=10.0) as r:
        return json.loads(r.read()), r.headers.get("X-Request-Id")


def test_http_propagates_the_request_id_and_phases_like_jax():
    made = {pkg: small_server(pkg, "hp") for pkg in (mx, jmx)}
    fronts = {pkg: pkg.serving.HttpFrontEnd(srv).start()
              for pkg, srv in made.items()}
    try:
        bodies = {}
        for pkg, front in fronts.items():
            body, hdr = _post(front.url + "/v1/models/hp:predict",
                              {"X-Request-Id": "caller-id-7"})
            assert hdr == body["request_id"] == "caller-id-7"
            bodies[pkg] = body
        assert set(bodies[mx]) == set(bodies[jmx])
        assert set(bodies[mx]["phases"]) == set(bodies[jmx]["phases"]) == \
            set(PHASES) | {"total_ms"}
        assert all(bodies[mx]["phases"][k] is not None for k in PHASES)
        assert bodies[mx]["phases"]["total_ms"] > 0
        kinds = {s["kind"] for s in trace.tail()
                 if s["trace"] == "caller-id-7"}
        assert kinds == {"request", "phase"}
        body, hdr = _post(fronts[mx].url + "/v1/models/hp:predict")
        assert hdr == body["request_id"] != "caller-id-7"
    finally:
        for pkg in fronts:
            fronts[pkg].close()
            made[pkg].drain(timeout=10.0)
            made[pkg].stop()


def _span(seq, name, t0, dur_ms, kind="span", trace_id=None, parent=None):
    return {"seq": seq, "name": name, "kind": kind, "trace": trace_id,
            "parent": parent, "t0": t0, "dur_ms": dur_ms, "lane": 1}


def _shards():
    return {
        0: {"rank": 0, "generation": 1, "t_wall": 1000.0, "t_mono": 50.0,
            "spans": [_span(i, f"a{i}", 40.0 + i * 0.5, 1.0)
                      for i in range(6)]
            + [_span(6, "request[m]", 41.0, 5.0, kind="request",
                     trace_id="req-x")],
            "flight": [{"seq": 0, "t_mono": 41.5, "t_wall": 0.0,
                        "kind": "serving.batch", "point": "m",
                        "label": None}]},
        1: {"rank": 1, "generation": 1, "t_wall": 1120.0, "t_mono": 9050.0,
            "spans": [_span(i, f"b{i}", 9041.0 + i * 0.25, 1.0)
                      for i in range(6)]
            + [{"torn": True}],
            "flight": []},
    }


def _validate_chrome(payload):
    assert set(payload) >= {"traceEvents", "displayTimeUnit"}
    events = payload["traceEvents"]
    assert events
    for ev in events:
        for key in ("name", "ph", "ts", "pid", "tid"):
            assert key in ev, (key, ev)
        assert ev["ph"] in ("X", "i", "C", "M"), ev
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
        if ev["ph"] == "i":
            assert "s" in ev
    return events


def test_merged_events_equal_jax_and_keep_each_rank_in_order():
    events = trace.merged_events(_shards())
    assert events == jtrace.merged_events(_shards())
    for rank, prefix in ((0, "a"), (1, "b")):
        xs = [e for e in events if e["pid"] == rank and e["ph"] == "X"
              and e["name"].startswith(prefix)]
        assert [e["name"] for e in xs] == [f"{prefix}{i}" for i in range(6)]
        stamps = [e["ts"] for e in xs]
        assert stamps == sorted(stamps) and min(stamps) >= 0
    assert {e["pid"] for e in events} == {0, 1}
    _validate_chrome({"traceEvents": events, "displayTimeUnit": "ms"})


def test_local_dump_is_a_chrome_trace_with_step_spans(tmp_path):
    """A trainer step commits a ``trainer.step`` span keyed
    ``step-g<gen>-r<rank>-<step>`` with its measured phases as children;
    ``dump`` writes it, the request spans and the flight tail as a valid
    Chrome trace."""
    trace.clear()
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=CPU)
    st = ShardedTrainer(net, mx.gluon.loss.L2Loss(),
                        mesh=DeviceMesh({"dp": 1}, devices=[CPU]))
    st.step(np.ones((2, 4), np.float32), np.zeros((2, 3), np.float32))
    step = [s for s in trace.tail() if s["kind"] == "step"]
    assert len(step) == 1 and step[0]["trace"] == "step-g0-r0-1"
    assert step[0]["attrs"]["phases"] == st.step_report()["phases"]
    kids = [s for s in trace.tail() if s["parent"] == step[0]["seq"]]
    assert {k["name"] for k in kids} <= set(st.step_report()["phases"])
    assert "compute" in {k["name"] for k in kids}
    srv = small_server(mx, "dm")
    try:
        srv.predict("dm", np.zeros((1, 6), np.float32), timeout=10.0)
    finally:
        srv.drain(timeout=10.0)
        srv.stop()
    out = trace.dump(str(tmp_path / "trace.json"))
    assert trace.last_dump() == out
    with open(out) as f:
        events = _validate_chrome(json.load(f))
    cats = {e.get("cat") for e in events}
    assert {"trace.step", "trace.phase", "trace.request", "flight"} <= cats
    from mxnet_tpu_torch import profiler

    profiler.set_config(filename=str(tmp_path / "prof.json"))
    profiler.set_state("run")
    try:
        mx.nd.ones((2,), ctx=CPU) + 1
    finally:
        profiler.set_state("stop")
    try:
        with open(trace.dump(str(tmp_path / "p.json"),
                             include_profiler=True)) as f:
            events = _validate_chrome(json.load(f))
        ops = [e for e in events if e.get("cat") == "operator"]
        assert ops and min(e["ts"] for e in events) >= 0
    finally:
        profiler.reset()
    with pytest.raises(MXNetError, match="fleet.py"):
        trace.dump(str(tmp_path / "f.json"), run_dir=str(tmp_path))
