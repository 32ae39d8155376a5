"""The port's serving path on the CPU at a small size: the example's
BERT-class classifier (chip_smoke.build_classifier, the structure of
examples/gluon/transformer_finetune.py) built from both packages with
the same weights, then ServedModel + ModelServer: concurrent requests
across buckets, admission control and drain."""
import threading

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import build_classifier, classifier_shapes, random_params
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.convert import load_jax_params

SMALL = {"vocab": 64, "units": 32, "hidden": 64, "heads": 4, "layers": 2,
         "seq_len": 16, "num_classes": 2}
# f32 logits through two encoder layers, two frameworks on the CPU
RTOL, ATOL = 1e-4, 1e-4
CPU = mx.cpu()


def _tokens(n, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, SMALL["vocab"], (n, SMALL["seq_len"])).astype(
        np.float32)


@pytest.fixture(scope="module")
def classifier():
    weights = random_params(SMALL, seed=0)
    clf = build_classifier(mx, SMALL)
    clf.initialize(ctx=CPU)
    load_jax_params(clf, weights)
    return clf, weights


def _served(clf, **kw):
    model = serving.ServedModel.from_block(
        "clf", clf, example_shape=(SMALL["seq_len"],), ctx=CPU)
    return model, serving.ModelServer(serving.ModelContainer([model]), **kw)


def test_classifier_matches_jax_package(classifier):
    clf, weights = classifier
    assert set(weights) == set(classifier_shapes(SMALL))
    jclf = build_classifier(jmx, SMALL)
    jclf.initialize(jmx.init.Xavier())
    x = _tokens(5, seed=1)
    jclf(jmx.nd.array(x))  # resolve deferred shapes
    jparams = jclf._collect_params_with_structure()
    assert set(jparams) == set(weights)
    for name, value in weights.items():
        jparams[name].set_data(jmx.nd.array(value))
    want = jclf(jmx.nd.array(x)).asnumpy()
    got = clf(mx.nd.array(x, ctx=CPU)).asnumpy()
    assert got.shape == (5, SMALL["num_classes"])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


def test_server_answers_concurrent_requests_across_buckets(classifier):
    clf, _ = classifier
    model, server = _served(clf, max_wait_ms=5.0)
    assert model.bucket_for(1) == 2 and model.bucket_for(9) == 16
    assert model.bucket_for(33) is None
    with pytest.raises(RuntimeError, match="not started"):
        server.warmup()
    server.start()
    assert server.warmup()["models"]["clf"]["buckets"] == [2, 4, 8, 16, 32]
    rs = np.random.RandomState(2)
    payloads = [[_tokens(rs.randint(1, 9), seed=10 * i + j)
                 for j in range(6)] for i in range(4)]
    futures = [[None] * 6 for _ in range(4)]

    def client(i):
        for j, x in enumerate(payloads[i]):
            futures[i][j] = server.submit("clf", x)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for row_p, row_f in zip(payloads, futures):
        for x, fut in zip(row_p, row_f):
            got = fut.result(timeout=60)
            want = clf(mx.nd.array(x, ctx=CPU)).asnumpy()
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    single = server.predict("clf", payloads[0][0][0])
    assert single.shape == (1, SMALL["num_classes"])
    stats = server.stats()["models"]["clf"]
    assert stats["completed"] == 25 and stats["failed"] == 0
    assert stats["rows"] + stats["padded_rows"] == sum(
        b * n for b, n in stats["bucket_census"].items())
    assert stats["p50_ms"] is not None and 0 < stats["batch_fill_ratio"] <= 1
    assert server.drain(timeout=30)
    with pytest.raises(serving.ServerDrainingError):
        server.submit("clf", payloads[0][0])
    with pytest.raises(serving.ModelNotFound):
        server.submit("other", payloads[0][0])


def test_snapshot_is_taken_at_build_time(classifier):
    clf, weights = classifier
    model, _ = _served(clf)
    x = _tokens(2, seed=3)
    assert model.warmup()["buckets"] == [2, 4, 8, 16, 32]
    before = model.run(x)[0]
    out_w = clf.out.weight
    saved = out_w.data()._data.clone()
    out_w.set_data(np.zeros(out_w.shape, np.float32))
    try:
        np.testing.assert_array_equal(model.run(x)[0], before)
    finally:
        out_w.set_data(saved.numpy())
    with pytest.raises(ValueError, match="rows shaped"):
        model.validate(np.zeros((2, 5)))
    with pytest.raises(ValueError, match="largest bucket"):
        model.validate(np.zeros((33, SMALL["seq_len"])))


def test_busy_on_full_queue_then_drain_answers_everything_admitted(
        classifier):
    clf, _ = classifier
    model, _ = _served(clf)
    batcher = serving.BucketBatcher(model, max_queue=8)  # not started yet
    admitted = [batcher.submit(_tokens(n, seed=20 + n)) for n in (3, 4, 1)]
    with pytest.raises(serving.ServerBusyError) as err:
        batcher.submit(_tokens(1, seed=30))
    assert err.value.depth == 8 and err.value.limit == 8
    assert batcher.queue_depth() == 8
    batcher.start()
    assert batcher.drain(timeout=30)
    for n, fut in zip((3, 4, 1), admitted):
        assert fut.result(timeout=1).shape == (n, SMALL["num_classes"])
    batcher.stop()
    snap = batcher.metrics.snapshot()
    assert snap["rejected"] == 1 and snap["completed"] == 3


def test_stop_fails_queued_requests():
    model = serving.ServedModel("id", lambda x: (x,), (3,),
                                device=CPU.torch_device())
    batcher = serving.BucketBatcher(model)
    fut = batcher.submit(np.ones((1, 3), np.float32))
    batcher.stop()
    with pytest.raises(serving.ServerDrainingError):
        fut.result(timeout=1)
    with pytest.raises(serving.RequestTimeout):
        serving.ServingFuture("m").result(timeout=0.01)


def test_failed_batch_fails_its_requests_and_serving_continues():
    def fwd(x):
        if (x < 0).any():
            raise ValueError("negative input")
        return (x * 2,)

    model = serving.ServedModel("dbl", fwd, (3,), device=CPU.torch_device())
    server = serving.ModelServer(serving.ModelContainer([model])).start()
    with pytest.raises(serving.RequestError, match="negative input"):
        server.predict("dbl", -np.ones((1, 3), np.float32), timeout=30)
    np.testing.assert_array_equal(
        server.predict("dbl", np.ones((2, 3), np.float32), timeout=30),
        np.full((2, 3), 2, np.float32))
    assert server.drain(timeout=30)
    stats = server.stats()["models"]["dbl"]
    assert stats["failed"] == 1 and stats["completed"] == 1
