"""Served buckets through the port's compile service (site
``"serving"``) on the CPU, against the JAX package's ``ServedModel``:
the BERT-class classifier (chip_smoke.build_classifier: 2 encoder cells,
64 units) served in float32 from the block and as the JAX package's int8
checkpoint, with the same weights (``convert.load_jax_params``).

On the CPU a bucket's entry is a plain call; the keys and statistics are
those a card's graphs get: one entry per bucket, none after ``warmup``
under traffic (as ``tests/test_serving.py:388-402``), a bucket first met
under traffic built once, a hybridized block served as one entry (its
CachedOp runs inside), two models of one server warming up and serving at
once, ``set_enabled(False)`` serving eagerly, and each model's captures
in ``stats()`` and ``model_info()``."""
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import build_classifier, make_task, random_params
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu_torch import compile as mxc
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.convert import load_jax_params

SMALL = {"vocab": 128, "units": 64, "hidden": 128, "heads": 4, "layers": 2,
         "seq_len": 16, "num_classes": 2}
CPU = mx.cpu()
BUCKETS = [2, 4, 8, 16, 32]
# float32 logits through two encoder cells, two frameworks on the CPU
# (tests/test_torch_serving.py's tolerance)
RTOL = ATOL = 1e-4
# int8 logits, port vs JAX (tests/test_torch_quant_flow.py, measured
# there): a float difference of 1e-7 can flip an activation code at a
# rounding boundary and the layers after it carry the flip on, so at
# least 90% of the rows must equal the JAX graph's eager evaluation
# (``eval_with``), every row must pick the JAX served model's class, and
# no logit may move by more than 5% of the largest logit. Row equality is
# not held against the JAX served model itself: XLA's compiled graph
# rounds differently from the JAX package's own eager evaluation in the
# last place (measured here: 50 of 74 rows equal, at most 6e-8 of the
# largest logit apart), where the port matched eval_with in 73.
EQUAL_ROWS = 0.9
LOGIT_SHARE = 0.05


def _tokens(n, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, SMALL["vocab"], (n, SMALL["seq_len"])).astype(
        np.float32)


def _serving():
    return dict(mxc.stats().get("serving", {"hits": 0, "misses": 0}))


@pytest.fixture(scope="module")
def pair():
    weights = random_params(SMALL, seed=0)
    clf = build_classifier(mx, SMALL, exportable=True, prefix="clf_")
    clf.initialize(ctx=CPU)
    load_jax_params(clf, weights)
    jclf = build_classifier(jmx, SMALL, exportable=True, prefix="clf_")
    jclf.initialize(jmx.init.Xavier())
    jclf(jmx.nd.array(_tokens(2, seed=0)))
    for name, p in jclf._collect_params_with_structure().items():
        p.set_data(jmx.nd.array(weights[name]))
    return clf, jclf


def _padded(x, bucket):
    out = np.zeros((bucket,) + x.shape[1:], np.float32)
    out[:x.shape[0]] = x
    return out


def _model(clf, name="clf"):
    return serving.ServedModel.from_block(
        name, clf, example_shape=(SMALL["seq_len"],), ctx=CPU)


def test_served_float32_buckets_match_the_jax_served_model(pair):
    clf, jclf = pair
    model = _model(clf)
    jmodel = jmx.serving.ServedModel.from_block(
        "clf", jclf, example_shape=(SMALL["seq_len"],))
    before = _serving()
    seen = set()
    for rows in (1, 2, 3, 5, 9, 17, 32, 3):
        x = _padded(_tokens(rows, seed=rows), model.bucket_for(rows))
        seen.add(x.shape[0])
        got = model.run(x, rows)[0]
        want = jmodel.run(x, rows)[0]
        assert got.shape == (rows, SMALL["num_classes"])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    after = _serving()
    assert after["misses"] - before["misses"] == len(seen) == 5
    assert after["hits"] - before["hits"] == 3
    st = model.capture_stats()
    assert (st["misses"], st["hits"], st["captures"]) == (5, 3, 0)
    assert sorted(st["capture_ms_by_bucket"]) == BUCKETS


def test_served_int8_checkpoint_matches_the_jax_served_model(pair, tmp_path):
    """The JAX package quantizes (naive, channel-wise) and saves; both
    packages serve the checkpoint through ``from_checkpoint``."""
    _, jclf = pair
    calib, _ = make_task(64, SMALL["seq_len"], SMALL["vocab"], 2, seed=1)
    with jmx.name.NameManager():
        jclf.export(str(tmp_path / "float"))
    jsym, jargs, jauxs = jmx.model.load_checkpoint(str(tmp_path / "float"),
                                                   0)
    qsym, qargs, qauxs = jq.quantize_model(
        jsym, jargs, jauxs, calib_mode="naive",
        calib_data=jmx.io.NDArrayIter(calib, batch_size=32,
                                      label_name=None))
    prefix = str(tmp_path / "int8")
    jmx.model.save_checkpoint(prefix, 0, qsym, qargs, qauxs)
    model = serving.ServedModel.from_checkpoint(
        "int8", prefix, 0, example_shape=(SMALL["seq_len"],), ctx=CPU)
    jmodel = jmx.serving.ServedModel.from_checkpoint(
        "int8", prefix, 0, example_shape=(SMALL["seq_len"],))
    assert model.quantized and jmodel.quantized
    model.warmup()
    before = _serving()
    rows_all = equal = 0
    for rows in (1, 3, 6, 12, 20, 32):
        x = _padded(_tokens(rows, seed=40 + rows), model.bucket_for(rows))
        got = model.run(x, rows)[0]
        want = jmodel.run(x, rows)[0]
        assert got.shape == want.shape == (rows, SMALL["num_classes"])
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        assert np.abs(got - want).max() <= LOGIT_SHARE * np.abs(want).max()
        graph = qsym.eval_with({"data": jmx.nd.array(x), **qargs}) \
            .asnumpy()[:rows]
        rows_all += rows
        equal += int((got == graph).all(axis=1).sum())
    assert equal >= EQUAL_ROWS * rows_all, f"{equal} of {rows_all} equal"
    after = _serving()
    assert after["misses"] == before["misses"]
    assert after["hits"] - before["hits"] == 6


def test_zero_entries_after_warmup_under_traffic(pair):
    """As tests/test_serving.py:388-402: after warmup the serving site
    serves only hits, across both models' ladders."""
    clf, _ = pair
    a = _model(clf, "a")
    b = serving.ServedModel.from_block("b", clf,
                                       example_shape=(SMALL["seq_len"],),
                                       buckets=[4, 8], ctx=CPU)
    server = serving.ModelServer(serving.ModelContainer([a, b]),
                                 max_wait_ms=2.0).start()
    try:
        warm = server.warmup()
        assert warm["models"]["b"]["buckets"] == [4, 8]
        st0 = _serving()
        rs = np.random.RandomState(3)
        for k in (1, 2, 3, 5, 8, 17, 32):
            got = server.predict("a", _tokens(k, seed=int(rs.randint(99))),
                                 timeout=60)
            assert got.shape == (k, SMALL["num_classes"])
        for k in (1, 3, 7):
            server.predict("b", _tokens(k, seed=k), timeout=60)
        st1 = _serving()
        assert st1["misses"] == st0["misses"]  # zero new entries
        assert st1["hits"] - st0["hits"] == 10
        info = server.model_info()
        stats = server.stats()["models"]
        for name, model, ladder in (("a", a, BUCKETS), ("b", b, [4, 8])):
            # the CPU captures nothing: its buckets are plain calls
            assert info[name]["captures"] == stats[name]["captures"] == 0
            assert info[name]["capture_ms"] == 0.0
            assert stats[name]["capture_ms_by_bucket"] == {}
            assert stats[name]["replays"] == 0
            assert sorted(model.capture_stats()["capture_ms_by_bucket"]) \
                == ladder
    finally:
        assert server.drain(timeout=30)


def test_a_bucket_first_met_under_traffic_is_built_once(pair):
    clf, _ = pair
    model = _model(clf)
    server = serving.ModelServer(serving.ModelContainer([model]),
                                 max_wait_ms=1.0).start()
    try:
        x = _tokens(3, seed=7)
        want = clf(mx.nd.array(x, ctx=CPU)).asnumpy()
        for _ in range(3):
            got = server.predict("clf", x, timeout=60)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        st = model.capture_stats()
        assert (st["misses"], st["hits"]) == (1, 2)
        assert list(st["capture_ms_by_bucket"]) == [4]
    finally:
        assert server.drain(timeout=30)


def test_two_models_warm_up_and_serve_at_once(pair):
    """One model warms up on its runner thread while the other, not
    warmed up, takes traffic (and builds its buckets under it)."""
    clf, _ = pair
    a, b = _model(clf, "a"), _model(clf, "b")
    server = serving.ModelServer(serving.ModelContainer([a, b]),
                                 max_wait_ms=1.0).start()
    payloads = [_tokens(k, seed=50 + k) for k in (1, 2, 3, 5, 8, 13)]
    answers, errors = {}, []

    def traffic():
        try:
            for i, x in enumerate(payloads):
                answers[i] = server.predict("b", x, timeout=60)
        except Exception as e:  # reported below
            errors.append(e)

    try:
        t = threading.Thread(target=traffic)
        t.start()
        server._batcher("a").warmup()
        t.join(timeout=120)
        assert not t.is_alive() and not errors
        for i, x in enumerate(payloads):
            want = clf(mx.nd.array(x, ctx=CPU)).asnumpy()
            np.testing.assert_allclose(answers[i], want, rtol=RTOL,
                                       atol=ATOL)
        assert a.capture_stats()["misses"] == len(BUCKETS)
        assert b.capture_stats()["misses"] == 4   # buckets 2, 4, 8, 16
    finally:
        assert server.drain(timeout=30)


def test_a_hybridized_block_serves_as_one_entry(pair):
    """The served forward calls the hybridized block inside its own
    entry: the block's CachedOp runs plainly into it."""
    clf, _ = pair
    clf.hybridize()
    try:
        model = _model(clf)
        x = _tokens(4, seed=9)
        cached = dict(mxc.stats().get("cachedop", {"misses": 0}))
        before = _serving()
        got = model.run(x)[0]
        assert _serving()["misses"] - before["misses"] == 1
        assert mxc.stats().get("cachedop", {"misses": 0})["misses"] == \
            cached["misses"]
        want = clf(mx.nd.array(x, ctx=CPU)).asnumpy()  # the cached op
        np.testing.assert_array_equal(got, want)
    finally:
        clf.hybridize(False)


def test_set_enabled_false_serves_eagerly(pair):
    clf, _ = pair
    model = _model(clf)
    x = _tokens(5, seed=11)
    want = model.run(x)[0]
    prev = mxc.set_enabled(False)
    try:
        before = _serving()
        got = model.run(x)[0]
        assert _serving() == before
    finally:
        mxc.set_enabled(prev)
    np.testing.assert_array_equal(got, want)
