"""The port's HTTP front end (mxnet_tpu_torch/serving/http.py) against the
JAX package's on 127.0.0.1 (port 0), over the same models and requests
(two Dense(16, relu) -> Dense(4) models served from the same weights in
both packages, on the CPU).

Each case sends one request to both front ends and holds the status code,
the JSON keys and the values (outputs within the serve tests' tolerance)
to each other: the routes of tests/test_serving.py:453 (healthz, models,
predict, an unknown model's 404, stats), a bad body (400), a full queue
(429 with Retry-After), a deadline drop (504 with ``"dropped": true``), a
failed batch (500), a draining server (503), priority and deadline in the
body, the request id echoed, and the prediction cache's ``cache_hit``.
Both front ends add ``"phases"`` to a response when request tracing is
on (the default), so the JSON keys compare whole; the phase times are
the two processes' own.
"""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import faults as jfaults
from mxnet_tpu_torch import faults

CPU = mx.cpu()
DIM, HIDDEN, CLASSES = 8, 16, 4
# float32 logits of two Dense layers, two frameworks on the CPU, and a
# round trip through JSON (tests/test_torch_serving.py's tolerance)
RTOL = ATOL = 1e-4
FAULTS = {jmx: jfaults, mx: faults}


def _net(pkg, seed):
    rs = np.random.RandomState(seed)
    weights = [(rs.randn(HIDDEN, DIM) * 0.5).astype(np.float32),
               (rs.randn(HIDDEN) * 0.1).astype(np.float32),
               (rs.randn(CLASSES, HIDDEN) * 0.5).astype(np.float32),
               (rs.randn(CLASSES) * 0.1).astype(np.float32)]
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


@pytest.fixture()
def fronts():
    """``make(**server_kw) -> {pkg: (front, server)}``; everything made
    is closed, drained and its faults cleared afterwards."""
    made = []

    def make(**kw):
        out = {}
        for pkg in (jmx, mx):
            c = pkg.serving.ModelContainer()
            extra = {"ctx": CPU} if pkg is mx else {}
            c.add_block("a", _net(pkg, 1), example_shape=(DIM,),
                        buckets=(2, 4, 8), **extra)
            c.add_block("b", _net(pkg, 2), example_shape=(DIM,),
                        buckets=(2, 4), **extra)
            server = pkg.serving.ModelServer(c, max_wait_ms=1.0,
                                             **kw).start()
            front = pkg.serving.HttpFrontEnd(server).start()
            made.append((front, server))
            out[pkg] = (front, server)
        return out

    yield make
    for front, server in made:
        front.close()
        try:
            server.drain(timeout=10.0)
        except Exception:
            pass
    faults.reset()
    jfaults.reset()


def _call(front, path, body=None, headers=None, raw=None):
    """``(status, json body, headers)`` of one request."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(front.url + path, data=data,
                                 headers=dict(headers or {}))
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=30.0) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _both(pairs, path, body=None, **kw):
    """The same request to both front ends: ``(port, jax)`` results,
    with equal status codes and equal JSON keys."""
    got = _call(pairs[mx][0], path, body, **kw)
    want = _call(pairs[jmx][0], path, body, **kw)
    assert got[0] == want[0], (got, want)
    assert set(got[1]) == set(want[1]), (got[1], want[1])
    return got, want


def _x(rows, seed=1):
    return np.random.RandomState(seed).randn(rows, DIM).astype(np.float32)


def test_routes_and_predictions_match_jax(fronts):
    pairs = fronts()
    (code, body, _), _ = _both(pairs, "/healthz")
    assert code == 200 and body == {"status": "ok"}
    got, want = _both(pairs, "/v1/models")
    assert got[1]["models"] == want[1]["models"] == ["a", "b"]
    for name, info in want[1]["detail"].items():
        assert {k: got[1]["detail"][name][k] for k in info} == info
    x = _x(3)
    got, want = _both(pairs, "/v1/models/a:predict", {"data": x.tolist()},
                      headers={"X-Request-Id": "rid-7"})
    assert got[0] == 200 and got[1]["model"] == "a"
    np.testing.assert_allclose(np.asarray(got[1]["outputs"][0]),
                               np.asarray(want[1]["outputs"][0]),
                               rtol=RTOL, atol=ATOL)
    assert np.asarray(got[1]["outputs"][0]).shape == (3, CLASSES)
    assert got[1]["model_version"] == want[1]["model_version"] == 0
    assert got[1]["request_id"] == want[1]["request_id"] == "rid-7"
    assert got[2]["X-Request-Id"] == want[2]["X-Request-Id"] == "rid-7"
    ref = pairs[mx][1].predict("a", x, timeout=10.0)
    np.testing.assert_allclose(np.asarray(got[1]["outputs"][0]), ref,
                               rtol=0, atol=1e-6)
    # the other paths of the predict route, and a minted request id
    got, _ = _both(pairs, "/models/b", {"data": x[:1].tolist()})
    assert got[0] == 200 and got[1]["request_id"]
    got, want = _both(pairs, "/v1/stats")
    assert got[0] == 200 and set(want[1]) <= set(got[1])
    for name, st in want[1]["models"].items():
        assert set(st) <= set(got[1]["models"][name])
    assert got[1]["model_bus"] is None and want[1]["model_bus"] is None


@pytest.mark.parametrize("path,body,raw,code", [
    ("/v1/models/ghost:predict", {"data": [[0.0] * DIM]}, None, 404),
    ("/v2/elsewhere", {"data": [[0.0] * DIM]}, None, 404),
    ("/v1/models/a:predict", None, b"{not json", 400),
    ("/v1/models/a:predict", {"rows": [[0.0] * DIM]}, None, 400),
    ("/v1/models/a:predict", {"data": [[0.0] * 3]}, None, 400),
    ("/v1/models/a:predict", {"data": [[0.0] * DIM], "priority": "urgent"},
     None, 400),
])
def test_client_errors_match_jax(fronts, path, body, raw, code):
    pairs = fronts()
    got, want = _both(pairs, path, body, raw=raw)
    assert got[0] == code and "error" in got[1]


def test_unknown_get_route_is_404(fronts):
    pairs = fronts()
    got, _ = _both(pairs, "/nothing/here")
    assert got[0] == 404
    # /metrics is ported (tests/test_torch_telemetry.py holds its values)
    url = pairs[mx][0].url + "/metrics"
    with urllib.request.urlopen(url, timeout=30.0) as r:
        assert r.status == 200
        assert r.headers["Content-Type"].startswith("text/plain")
        assert "mxtpu_serving_requests_total" in r.read().decode()


def test_full_queue_is_429_with_retry_after(fronts):
    pairs = fronts(max_queue=1)
    got, want = _both(pairs, "/v1/models/a:predict",
                      {"data": _x(2).tolist()})
    assert got[0] == 429
    assert got[2]["Retry-After"] == want[2]["Retry-After"] == "0.1"


def test_deadline_drop_is_504_dropped(fronts):
    pairs = fronts()
    for _ in range(3):   # a measured batch time behind the estimate
        _both(pairs, "/v1/models/a:predict", {"data": _x(1).tolist()})
    got, want = _both(pairs, "/v1/models/a:predict",
                      {"data": _x(1).tolist(), "priority": "batch",
                       "deadline_ms": 1e-6})
    assert got[0] == 504 and got[1]["dropped"] is True
    assert want[1]["dropped"] is True
    got, _ = _both(pairs, "/v1/models/a:predict",
                   {"data": _x(1).tolist(), "priority": "batch",
                    "deadline_ms": 30000})
    assert got[0] == 200
    st = pairs[mx][1].stats()["models"]["a"]
    assert st["deadline_dropped"] == {"submit": 1}
    assert st["deadline_met"] == 1


def test_failed_batch_is_500(fronts):
    pairs = fronts()
    for pkg in (jmx, mx):
        FAULTS[pkg].configure("serving.batch:raise@1")
    got, _ = _both(pairs, "/v1/models/a:predict", {"data": _x(1).tolist()})
    assert got[0] == 500 and "failed" in got[1]["error"]
    got, _ = _both(pairs, "/v1/models/a:predict", {"data": _x(1).tolist()})
    assert got[0] == 200


def test_draining_server_is_503(fronts):
    pairs = fronts()
    for pkg in (jmx, mx):
        assert pairs[pkg][1].drain(timeout=10.0)
    got, want = _both(pairs, "/v1/models/a:predict",
                      {"data": _x(1).tolist()})
    assert got[0] == 503 and got[2]["Retry-After"] == "1"
    (code, body, _), _ = _both(pairs, "/healthz")
    assert code == 200 and body == {"status": "draining"}


def test_cache_hit_flag_matches_jax(fronts):
    pairs = fronts(cache=True)
    body = {"data": _x(2, seed=4).tolist()}
    first, _ = _both(pairs, "/v1/models/b:predict", body)
    assert "cache_hit" not in first[1]
    got, want = _both(pairs, "/v1/models/b:predict", body)
    assert got[1]["cache_hit"] is True and want[1]["cache_hit"] is True
    assert got[1]["outputs"] == first[1]["outputs"]
