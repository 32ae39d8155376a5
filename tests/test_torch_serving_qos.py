"""The port's serving configuration, prediction cache and QoS (priority
classes, deadlines) against the JAX package's, on the CPU at a small
size (a Dense(16, relu) -> Dense(4) model served from the same weights in
both packages).

* ``configure`` / ``effective`` / ``describe`` of ``MXNET_TPU_SERVING``
  strings, and the errors of bad specs, equal in both packages;
* ``content_key`` byte-identical across packages; the LRU, invalidation
  and version-flip cases of tests/test_fleet.py:589-660 and the deadline
  drop before a batch slot (:560) run against the port;
* the collector's drain order (interactive first, batch into the rows
  left), the partitioned admission bound and the drop of a request whose
  deadline expired in the queue, popped from unstarted batchers of both
  packages over the same submissions.
"""
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.serving import cache as jcache
from mxnet_tpu_torch import faults, serving
from mxnet_tpu_torch.serving import cache as pcache

CPU = mx.cpu()
DIM, HIDDEN, CLASSES = 8, 16, 4
# float32 logits of two Dense layers, two frameworks on the CPU
# (tests/test_torch_serving.py's tolerance)
RTOL = ATOL = 1e-4


def _weights(seed=7):
    rs = np.random.RandomState(seed)
    return [(rs.randn(HIDDEN, DIM) * 0.5).astype(np.float32),
            (rs.randn(HIDDEN) * 0.1).astype(np.float32),
            (rs.randn(CLASSES, HIDDEN) * 0.5).astype(np.float32),
            (rs.randn(CLASSES) * 0.1).astype(np.float32)]


def _net(pkg, weights):
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(HIDDEN, activation="relu"), nn.Dense(CLASSES))
    if pkg is mx:
        net.initialize(ctx=CPU)
        net(mx.nd.zeros((2, DIM), ctx=CPU))
    else:
        net.initialize()
        net(jmx.nd.zeros((2, DIM)))
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(w if pkg is mx else jmx.nd.array(w))
    return net


def _model(pkg, buckets=(2, 4)):
    kw = {"ctx": CPU} if pkg is mx else {}
    return pkg.serving.ServedModel.from_block(
        "m", _net(pkg, _weights()), example_shape=(DIM,), buckets=buckets,
        **kw)


def _tiny_server(pkg=mx, **kw):
    c = pkg.serving.ModelContainer([_model(pkg)])
    return pkg.serving.ModelServer(c, max_wait_ms=1.0, **kw).start()


@pytest.fixture(autouse=True)
def _restore_config():
    yield
    serving.configure_from_env()
    jserving.configure_from_env()
    faults.reset()


# --------------------------------------------------------------- config --

SPECS = ["buckets:2|4;max_queue:7,max_wait_ms:1.5,timeout_ms:500,stage:0",
         "cache:1,cache_entries:16", "buckets:32|2|8|8", "stage:off;cache:no",
         ""]
BAD_SPECS = ["max_qeue:5", "buckets:a|b", "max_queue", "max_queue:0",
             "max_wait_ms:-1", "buckets:0|2", "cache_entries:0"]


@pytest.mark.parametrize("spec", SPECS)
def test_configure_matches_jax(spec):
    assert serving.configure(spec) == jserving.configure(spec)
    assert serving.effective() == jserving.effective()
    assert serving.describe() == jserving.describe()


def test_configure_dict_and_keywords_match_jax():
    got = serving.configure({"max_queue": 64}, max_wait_ms=1.0,
                            buckets=[8, 2])
    assert got == jserving.configure({"max_queue": 64}, max_wait_ms=1.0,
                                     buckets=[8, 2])
    assert got["buckets"] == (2, 8) and got["max_queue"] == 64
    serving.configure_from_env()
    assert serving.effective() == serving.DEFAULTS


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_like_jax(spec):
    with pytest.raises(ValueError) as want:
        jserving.configure(spec)
    with pytest.raises(ValueError) as got:
        serving.configure(spec)
    assert str(got.value) == str(want.value)


def test_environment_spec_and_invalid_one_match_jax(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SERVING", "buckets:2|8,max_queue:9")
    serving.configure_from_env()
    jserving.configure_from_env()
    assert serving.effective() == jserving.effective()
    assert serving.effective()["max_queue"] == 9
    assert serving.describe()["env"] == "buckets:2|8,max_queue:9"
    # an invalid environment spec is ignored (with a warning): defaults
    monkeypatch.setenv("MXNET_TPU_SERVING", "max_queue:zero")
    serving.configure_from_env()
    jserving.configure_from_env()
    assert serving.effective() == jserving.effective() == serving.DEFAULTS


def test_configured_defaults_reach_models_and_batchers():
    serving.configure("buckets:2|8,max_queue:5,cache:1,cache_entries:3")
    model = _model(mx, buckets=None)
    assert model.buckets == (2, 8)
    b = serving.BucketBatcher(model)
    assert b._max_queue == 5 and b.cache is not None
    assert b.cache.capacity == 3
    assert serving.BucketBatcher(model, cache=False).cache is None


# ---------------------------------------------------------------- cache --

def test_content_key_is_byte_identical_across_packages():
    rs = np.random.RandomState(0)
    arrays = [rs.randn(1, 8).astype(np.float32),
              rs.randn(3, 8).astype(np.float32),
              rs.randint(0, 9, (2, 4)).astype(np.int32),
              np.zeros((1, 4), np.float32), np.zeros((4, 1), np.float32),
              rs.randn(2, 8).astype(np.float32)[:, ::2]]
    keys = set()
    for a in arrays:
        for version in (0, 3):
            k = pcache.content_key("m", version, a)
            assert k == jcache.content_key("m", version, a)
            keys.add(k)
    assert len(keys) == 2 * len(arrays)  # shape, dtype, version all count


def test_prediction_cache_unit_lru_and_invalidation():
    """tests/test_fleet.py:626-649 against the port's cache."""
    pc = pcache.PredictionCache(capacity=2)
    a = np.zeros((1, 4), np.float32)
    k1 = pcache.content_key("m", 1, a)
    assert pcache.content_key("m", 2, a) != k1
    assert pc.get(k1) is None
    pc.put(k1, a, version=1)
    hit = pc.get(k1)
    assert hit is not None
    hit[:] = 99.0                                  # copies never alias
    assert float(pc.get(k1)[0, 0]) == 0.0
    pc.put("k2", a, version=1)
    pc.put("k3", a, version=1)
    assert len(pc) == 2 and pc.get(k1) is None
    pc.observe_version(1)
    assert len(pc) == 2
    pc.observe_version(2)
    assert len(pc) == 0 and pc.stats()["invalidations"] == 2
    assert set(pc.stats()) == set(jcache.PredictionCache().stats())


def test_prediction_cache_put_under_a_new_version_drops_the_old():
    pc, jpc = pcache.PredictionCache(8), jcache.PredictionCache(8)
    a = np.ones((1, 4), np.float32)
    for c in (pc, jpc):
        c.put("a", a, version=0)
        c.put("b", [a, a * 2], version=0)
        got = c.get("b")
        assert isinstance(got, list) and np.array_equal(got[1], a * 2)
        c.put("c", a, version=5)
        assert len(c) == 1 and c.get("a") is None
        assert c.invalidate(version=6) == 1
    assert pc.stats() == jpc.stats()


def test_prediction_cache_correct_across_version_flip():
    """tests/test_fleet.py:597-623 against the port: hits answer the
    served version, and a live swap makes the next request compute on the
    new weights."""
    server = _tiny_server(cache=True)
    try:
        server.warmup()
        x = np.random.RandomState(1).randn(1, DIM).astype(np.float32)
        f1 = server.submit("m", x)
        r1 = np.asarray(f1.result(timeout=30.0)[0])
        assert f1.cache_hit is False and f1.model_version == 0
        f2 = server.submit("m", x)
        r2 = np.asarray(f2.result(timeout=30.0)[0])
        assert f2.cache_hit is True and np.allclose(r1, r2)
        model = server.container.get("m")
        praws, araws, _v = model.pinned()
        model.swap_params([np.asarray(p) * 1.5 for p in praws],
                          version=7, aux_raws=araws)
        f3 = server.submit("m", x)
        r3 = np.asarray(f3.result(timeout=30.0)[0])
        assert f3.cache_hit is False and f3.model_version == 7
        assert not np.allclose(r1, r3)
        f4 = server.submit("m", x)
        assert f4.cache_hit is True and f4.model_version == 7
        assert np.allclose(r3, np.asarray(f4.result(timeout=30.0)[0]))
        st = server.stats()["models"]["m"]
        assert st["cache"]["hits"] == st["cache_hits"] == 2
        assert st["cache"]["version"] == 7 and st["model_version"] == 7
    finally:
        server.drain(timeout=10.0)


def test_cache_hits_match_jax_answers():
    """The same requests through both packages' cached servers: the same
    hit pattern, answers within the serve tests' tolerance."""
    rs = np.random.RandomState(2)
    payloads = [rs.randn(k, DIM).astype(np.float32) for k in (1, 2, 3)]
    runs = {}
    for pkg in (jmx, mx):
        server = _tiny_server(pkg, cache=True)
        try:
            futs = [server.submit("m", p) for p in payloads + payloads]
            runs[pkg] = [(f.result(30.0), f.cache_hit) for f in futs]
            runs[pkg].append(sorted(server.stats()["models"]["m"]))
        finally:
            server.drain(timeout=10.0)
    *got, got_keys = runs[mx]
    *want, want_keys = runs[jmx]
    for (g, gh), (w, wh) in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
        assert gh == wh
    # the port's stats add its device and bucket graphs to the JAX keys
    assert set(want_keys) <= set(got_keys)


# ------------------------------------------------------------- deadlines --

def test_deadline_drop_before_batch_slot():
    """tests/test_fleet.py:560-587 against the port."""
    server = _tiny_server()
    try:
        server.warmup()
        x = np.random.RandomState(0).randn(1, DIM).astype(np.float32)
        for _ in range(4):
            server.submit("m", x).result(timeout=30.0)
        before = server.stats()["models"]["m"]
        assert before.get("deadline_dropped", {}) == {}
        with pytest.raises(serving.DeadlineExceeded) as ei:
            server.submit("m", x, deadline_ms=1e-4)
        assert ei.value.where == "submit" and ei.value.estimate_ms > 0
        after = server.stats()["models"]["m"]
        assert after["deadline_dropped"] == {"submit": 1}
        assert after["batches"] == before["batches"]  # no slot consumed
        server.submit("m", x, deadline_ms=30000.0).result(timeout=30.0)
        assert server.stats()["models"]["m"]["deadline_met"] == 1
    finally:
        server.drain(timeout=10.0)


def test_deadline_error_matches_jax():
    got = serving.DeadlineExceeded("m", 5.0, 7.25, where="submit")
    want = jserving.DeadlineExceeded("m", 5.0, 7.25, where="submit")
    assert str(got) == str(want)
    assert isinstance(got, serving.ServingError)


def _batchers(max_queue=1024, buckets=(2, 4)):
    """Unstarted batchers of both packages over the same weights."""
    return {pkg: pkg.serving.BucketBatcher(
        _model(pkg, buckets=buckets), max_queue=max_queue, stage=False)
        for pkg in (jmx, mx)}


def _popped(b):
    reqs, rows = b._collect()
    return [int(r.arr[0, 0]) for r in reqs], rows


def _row(tag, n=1):
    return np.full((n, DIM), float(tag), np.float32)


def test_interactive_requests_drain_first():
    """Batch requests queued before interactive ones still wait: each
    bucket takes interactive rows first and batch rows into what is
    left, in both packages."""
    orders = {}
    for pkg, b in _batchers().items():
        for tag in (1, 2, 3):
            b.submit(_row(tag), priority="batch")
        for tag in (10, 11, 12):
            b.submit(_row(tag), priority="interactive")
        orders[pkg] = [_popped(b), _popped(b)]
        assert b.queue_depth() == 0
    assert orders[mx] == orders[jmx] == [([10, 11, 12, 1], 4),
                                         ([2, 3], 2)]


def test_admission_bound_is_partitioned_by_class():
    """Batch rows count against the whole queue, interactive rows
    against the interactive queue alone."""
    outcomes = {}
    for pkg, b in _batchers(max_queue=4).items():
        got = []
        for prio, n in (("batch", 3), ("interactive", 2), ("batch", 1),
                        ("interactive", 2), ("interactive", 1)):
            try:
                b.submit(_row(n, n), priority=prio)
                got.append("ok")
            except pkg.serving.ServerBusyError as e:
                got.append(("busy", e.depth, e.limit))
        outcomes[pkg] = got
    assert outcomes[mx] == outcomes[jmx] == [
        "ok", "ok", ("busy", 5, 4), "ok", ("busy", 4, 4)]


def test_expired_request_is_dropped_at_pop():
    for pkg, b in _batchers().items():
        doomed = b.submit(_row(1), priority="batch", deadline_ms=1.0)
        live = b.submit(_row(2), priority="batch")
        time.sleep(0.01)
        assert _popped(b) == ([2], 1)
        with pytest.raises(pkg.serving.DeadlineExceeded) as ei:
            doomed.result(1.0)
        assert ei.value.where == "queue"
        assert b.metrics.snapshot()["deadline_dropped"] == {"queue": 1}
        assert not live.done()


def test_priority_is_validated_and_futures_carry_it():
    for pkg, b in _batchers().items():
        with pytest.raises(ValueError, match="unknown priority"):
            b.submit(_row(1), priority="urgent")
        fut = b.submit(_row(1), priority="batch", deadline_ms=250)
        assert (fut.priority, fut.deadline_ms) == ("batch", 250.0)
        assert fut.model_version is None and fut.cache_hit is False
        # request tracing is on by default in both packages: an id at
        # submit, the breakdown once answered
        assert fut.request_id and fut.breakdown() is None
    assert serving.PRIORITIES == jserving.PRIORITIES


def test_equal_requests_ride_one_batch():
    """With the cache on, a request equal to one still queued attaches to
    it and is answered by its batch (counted as coalesced)."""
    model = _model(mx)
    b = serving.BucketBatcher(model, cache=True, max_wait_ms=0.0)
    x = _row(3)
    f1 = b.submit(x)
    f2 = b.submit(x)
    assert b.metrics.snapshot()["coalesced"] == 1 and b.queue_depth() == 1
    b.start()
    try:
        r1, r2 = f1.result(10.0), f2.result(10.0)
        assert np.array_equal(r1, r2) and f2.model_version == 0
        f3 = b.submit(x)
        assert f3.cache_hit and np.array_equal(f3.result(1.0), r1)
    finally:
        b.drain(5.0)
        b.stop()


def test_failed_batch_fails_its_requests_and_the_server_keeps_serving():
    """``serving.batch:raise`` fails one batch with a RequestError; the
    next batch is answered."""
    server = _tiny_server()
    try:
        server.warmup()
        faults.configure("serving.batch:raise@1")
        x = np.zeros((1, DIM), np.float32)
        with pytest.raises(serving.RequestError):
            server.predict("m", x, timeout=10.0)
        assert server.predict("m", x, timeout=10.0).shape == (1, CLASSES)
        st = server.stats()["models"]["m"]
        assert st["failed"] == 1 and st["stalled_batches"] == 0
    finally:
        server.drain(timeout=10.0)


def test_latency_by_class_in_stats(monkeypatch, tmp_path):
    server = _tiny_server()
    try:
        x = np.zeros((1, DIM), np.float32)
        for prio in ("interactive", "batch", "batch"):
            server.predict("m", x, timeout=10.0, priority=prio)
        by_class = server.stats()["models"]["m"]["by_class"]
        assert by_class["interactive"]["count"] == 1
        assert by_class["batch"]["count"] == 2
        assert set(by_class["batch"]) == {"count", "p50_ms", "p99_ms"}
        assert serving.live_servers() and any(
            s["name"] == server.name for s in serving.live_stats())
    finally:
        server.drain(timeout=10.0)
    # a drain request ends run_until_drained with the drain record
    from mxnet_tpu_torch import preempt

    monkeypatch.setenv("MXNET_TPU_PREEMPT_DIR", str(tmp_path))
    preempt.request("test")
    try:
        ev = server.run_until_drained(install=False)
    finally:
        preempt.clear()
    assert ev["exit_code"] == 75 and ev["serving"]["drained"] is True
