"""The port's kvstore (mxnet_tpu_torch/kvstore/) against the JAX package's
on the CPU: the ``local`` and ``device`` stores (init, pushes of lists,
pulls into lists, pushpull, broadcast, string keys, optimizer-on-store
through the Updater), the 2-bit compressed reduction of a one-process
``dist_sync``, the bucket plan, and the one place where the port follows
MXNet 1.x instead of the JAX package: what a ``dist_sync`` pull returns.
(Two worker processes: tests/test_torch_dist.py.)"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.kvstore import buckets as jbuckets
from mxnet_tpu_torch.kvstore import buckets

CPU = mx.cpu()


def _pair(a):
    return mx.nd.array(a, ctx=CPU), jmx.nd.array(a)


def _eq(port, jax_arr):
    np.testing.assert_array_equal(port.asnumpy(), jax_arr.asnumpy())


@pytest.mark.parametrize("kind", ["local", "device"])
def test_push_pull_lists_pushpull_broadcast_match_jax(kind):
    rs = np.random.RandomState(0)
    kv, jkv = mx.kv.create(kind), jmx.kv.create(kind)
    assert kv.type == kind and (kv.rank, kv.num_workers) == (0, 1)
    shapes = {3: (4,), 5: (2, 3)}
    for key, shape in shapes.items():
        a = rs.randn(*shape).astype(np.float32)
        p, j = _pair(a)
        kv.init(key, p)
        jkv.init(key, j)
    # a key pushed as a list of values sums them; two keys at once
    vals = {k: [rs.randn(*s).astype(np.float32) for _ in range(3)]
            for k, s in shapes.items()}
    kv.push(list(shapes), [[mx.nd.array(a, ctx=CPU) for a in vals[k]]
                           for k in shapes])
    jkv.push(list(shapes), [[jmx.nd.array(a) for a in vals[k]]
                            for k in shapes])
    for key, shape in shapes.items():
        outs = [mx.nd.zeros(shape, ctx=CPU) for _ in range(2)]
        jouts = [jmx.nd.zeros(shape) for _ in range(2)]
        kv.pull(key, out=outs)
        jkv.pull(key, out=jouts)
        for o, jo in zip(outs, jouts):
            _eq(o, jo)
        np.testing.assert_allclose(outs[0].asnumpy(), sum(vals[key]),
                                   rtol=1e-6)
    # pushpull and broadcast
    g = rs.randn(4).astype(np.float32)
    out, jout = mx.nd.zeros((4,), ctx=CPU), jmx.nd.zeros((4,))
    kv.pushpull(3, mx.nd.array(g, ctx=CPU), out)
    jkv.pushpull(3, jmx.nd.array(g), jout)
    _eq(out, jout)
    b = rs.randn(2, 2).astype(np.float32)
    outs = [mx.nd.zeros((2, 2), ctx=CPU) for _ in range(2)]
    jouts = [jmx.nd.zeros((2, 2)) for _ in range(2)]
    kv.broadcast("w", mx.nd.array(b, ctx=CPU), outs)
    jkv.broadcast("w", jmx.nd.array(b), jouts)
    for o, jo in zip(outs, jouts):
        _eq(o, jo)


def test_string_keys_and_uninitialized_key():
    kv, jkv = mx.kv.create("local"), jmx.kv.create("local")
    for store, nd, ctx in ((kv, mx.nd, {"ctx": CPU}), (jkv, jmx.nd, {})):
        store.init(["emb", "fc"], [nd.array(np.ones(3, np.float32), **ctx),
                                   nd.array(np.zeros(2, np.float32), **ctx)])
        store.push("fc", nd.array(np.array([1, 2], np.float32), **ctx))
    out, jout = mx.nd.zeros((2,), ctx=CPU), jmx.nd.zeros((2,))
    kv.pull("fc", out=out)
    jkv.pull("fc", out=jout)
    _eq(out, jout)
    out, jout = mx.nd.zeros((3,), ctx=CPU), jmx.nd.zeros((3,))
    kv.pull("emb", out=out)
    jkv.pull("emb", out=jout)
    _eq(out, jout)
    with pytest.raises(ValueError, match="not been initialized"):
        kv.pull("nope", out=out)


def test_a_pushed_array_overwritten_before_the_pull_is_not_read():
    kv = mx.kv.create("local")
    kv.init(0, mx.nd.zeros((3,), ctx=CPU))
    g = mx.nd.array(np.array([1, 2, 3], np.float32), ctx=CPU)
    kv.push(0, g)
    g._data.fill_(9.0)
    out = mx.nd.zeros((3,), ctx=CPU)
    kv.pull(0, out=out)
    assert out.asnumpy().tolist() == [1, 2, 3]


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("sgd", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
])
def test_optimizer_on_store_matches_jax(optimizer, params):
    """set_optimizer: each push updates the stored weight through the
    Updater (Optimizer.update); three rounds, float32 on the CPU in both
    packages, to 1e-6."""
    rs = np.random.RandomState(1)
    w0 = rs.randn(5, 4).astype(np.float32)
    kv, jkv = mx.kv.create("local"), jmx.kv.create("local")
    kv.set_optimizer(mx.optimizer.create(optimizer, **params))
    jkv.set_optimizer(jmx.optimizer.create(optimizer, **params))
    kv.init(7, mx.nd.array(w0, ctx=CPU))
    jkv.init(7, jmx.nd.array(w0))
    for _ in range(3):
        g = rs.randn(5, 4).astype(np.float32)
        kv.push(7, mx.nd.array(g, ctx=CPU))
        jkv.push(7, jmx.nd.array(g))
    out, jout = mx.nd.zeros((5, 4), ctx=CPU), jmx.nd.zeros((5, 4))
    kv.pull(7, out=out)
    jkv.pull(7, out=jout)
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), rtol=1e-6,
                               atol=1e-7)
    assert not np.allclose(out.asnumpy(), w0)
    assert sorted(kv._updater.states) == [7]


def test_gradient_compression_setting_matches_jax():
    kv, jkv = mx.kv.create("local"), jmx.kv.create("local")
    assert kv.gradient_compression == jkv.gradient_compression == {}
    kv.set_gradient_compression({"type": "2bit"})
    jkv.set_gradient_compression({"type": "2bit"})
    assert kv.gradient_compression == jkv.gradient_compression == {
        "type": "2bit", "threshold": 0.5}
    kv.set_gradient_compression(None)
    assert kv.gradient_compression == {}
    with pytest.raises(ValueError):
        kv.set_gradient_compression({"type": "1bit"})


def test_compressed_cross_host_sum_one_process_matches_jax():
    """The values of tests/test_sparse_dist.py:122-137, in both
    packages: quantized to {-thr, 0, +thr}, the error fed back."""
    kv, jkv = mx.kv.create("dist_sync"), jmx.kv.create("dist_sync")
    assert (kv.rank, kv.num_workers) == (0, 1)
    for store in (kv, jkv):
        store.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    g = [0.7, -0.9, 0.2, 0.0]
    out = kv._compressed_cross_host_sum("k", mx.nd.array(g, ctx=CPU))
    jout = jkv._compressed_cross_host_sum("k", jmx.nd.array(g))
    np.testing.assert_array_equal(out.asnumpy(), [0.5, -0.5, 0.0, 0.0])
    _eq(out, jout)
    np.testing.assert_array_equal(kv._residuals["k"].numpy(),
                                  np.asarray(jkv._residuals["k"]))
    np.testing.assert_allclose(kv._residuals["k"].numpy(),
                               [0.2, -0.4, 0.2, 0.0], atol=1e-6)
    g2 = [0.31, 0.0, 0.0, 0.0]
    out2 = kv._compressed_cross_host_sum("k", mx.nd.array(g2, ctx=CPU))
    jout2 = jkv._compressed_cross_host_sum("k", jmx.nd.array(g2))
    assert out2.asnumpy()[0] == 0.5
    _eq(out2, jout2)


@pytest.mark.parametrize("cap", [0, 1, 64, 4 << 10, 4 << 20])
def test_bucket_plan_matches_jax(cap):
    rs = np.random.RandomState(cap % 97)
    regs = [(i, tuple(int(d) for d in rs.randint(1, 40, rs.randint(1, 3))),
             "float32" if rs.rand() < 0.8 else "int8") for i in range(60)]
    regs.append(("big", (300, 300), "float32"))
    plan, jplan = buckets.BucketPlan(cap), jbuckets.BucketPlan(cap)
    for key, shape, dtype in regs:
        assert plan.register(key, shape, dtype) == \
            jplan.register(key, shape, dtype)
    assert plan.info == jplan.info
    assert plan.buckets == jplan.buckets


def test_bucket_cap_from_the_environment(monkeypatch):
    monkeypatch.delenv("MXNET_TPU_BUCKET_BYTES", raising=False)
    assert buckets.bucket_bytes() == jbuckets.bucket_bytes() == 4 << 20
    for raw, want in (("0", 0), ("1024", 1024), ("-5", 0), ("junk", 4 << 20)):
        monkeypatch.setenv("MXNET_TPU_BUCKET_BYTES", raw)
        assert buckets.bucket_bytes() == jbuckets.bucket_bytes() == want
    monkeypatch.setenv("MXNET_TPU_BUCKET_BYTES", "0")
    assert mx.kv.create("dist_sync")._pipeline is None


def test_forced_bucket_pipeline_one_process_equals_the_per_key_path(
        monkeypatch):
    """MXNET_TPU_BUCKET_FORCE=1 runs a one-worker group through staging,
    fusion and resolve; the pulls equal the per-key path's."""
    rs = np.random.RandomState(4)
    grads = [rs.randn(3, 5).astype(np.float32) for _ in range(4)]
    results = []
    for force in ("1", "0"):
        monkeypatch.setenv("MXNET_TPU_BUCKET_FORCE", force)
        monkeypatch.setenv("MXNET_TPU_BUCKET_BYTES", "128")
        kv = mx.kv.create("dist_sync")
        for i in range(4):
            kv.init(i, mx.nd.zeros((3, 5), ctx=CPU))
        for i in reversed(range(4)):
            kv.push(i, mx.nd.array(grads[i], ctx=CPU))
        outs = [mx.nd.zeros((3, 5), ctx=CPU) for _ in range(4)]
        for i in range(4):
            kv.pull(i, out=outs[i])
        if force == "1":
            # 60 bytes a key, so two keys a bucket
            assert kv._pipeline.stats["fused"] == 2
        results.append([o.asnumpy() for o in outs])
    for a, b, g in zip(*results, grads):
        np.testing.assert_array_equal(a, g)
        np.testing.assert_array_equal(b, g)


def test_dist_sync_pull_returns_this_rounds_sum_unlike_the_jax_package():
    """After init(0, [10, 10]), push [1, 2] and pull, twice: MXNet 1.x
    (KVStoreLocal, and KVStoreDistServer without an updater) returns the
    merged push, [1, 2], both times, and so does the port's dist_sync and
    both packages' local store. The JAX package's dist_sync adds the
    pushes to the stored value instead: [11, 12], then [12, 14]
    (ROADMAP.md section C)."""
    def rounds(store, nd, ctx):
        store.init(0, nd.array(np.array([10, 10], np.float32), **ctx))
        got = []
        for _ in range(2):
            store.push(0, nd.array(np.array([1, 2], np.float32), **ctx))
            out = nd.zeros((2,), **ctx)
            store.pull(0, out=out)
            got.append(out.asnumpy().tolist())
        return got

    assert rounds(mx.kv.create("dist_sync"), mx.nd, {"ctx": CPU}) == \
        [[1, 2], [1, 2]]
    assert rounds(mx.kv.create("local"), mx.nd, {"ctx": CPU}) == \
        [[1, 2], [1, 2]]
    assert rounds(jmx.kv.create("local"), jmx.nd, {}) == [[1, 2], [1, 2]]
    assert rounds(jmx.kv.create("dist_sync"), jmx.nd, {}) == \
        [[11, 12], [12, 14]]


def test_unported_stores_and_sparse_pull_raise():
    """dist_async and row_sparse_pull are ported (this slice's
    tests/test_torch_sparse_kvstore.py and test_torch_sparse_dist.py):
    an unknown store type and a row pull without row ids still raise."""
    assert mx.kv.create("dist_async").type == "dist_async"
    with pytest.raises(ValueError, match="unknown"):
        mx.kv.create("no-such-store")
    with pytest.raises(ValueError, match="unknown"):
        mx.kv.create("dist_no_such_mode")
    kv = mx.kv.create("local")
    with pytest.raises(ValueError, match="row_ids"):
        kv.row_sparse_pull(0, out=None, row_ids=None)


def test_dist_store_without_a_reachable_group_raises(monkeypatch):
    """Two workers and no coordinator, or one nobody answers: the store
    raises instead of shrinking to one worker."""
    import socket

    from mxnet_tpu_torch import base

    monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
    monkeypatch.setenv("MXTPU_WORKER_ID", "1")
    monkeypatch.delenv("MXTPU_COORDINATOR", raising=False)
    with pytest.raises(mx.MXNetError, match="MXTPU_COORDINATOR"):
        mx.kv.create("dist_sync")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MXTPU_COORDINATOR", f"127.0.0.1:{port}")
    monkeypatch.setattr(base, "RENDEZVOUS_TIMEOUT_S", 2.0)
    with pytest.raises(mx.MXNetError, match="could not join"):
        mx.kv.create("dist_sync")
    assert not torch.distributed.is_initialized()
