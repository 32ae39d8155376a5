"""The kvstore's sparse path and the lazy row-sparse SGD against the JAX
package on the CPU: pushes of row-sparse lists (row union), pulls and
``row_sparse_pull`` into row-sparse and dense ``out``; ``SGD`` on a
row-sparse gradient with and without momentum, weight decay, clip and
``rescale_grad`` against JAX ``SGD._sparse_update`` (rtol 1e-6, atol
1e-7); Adam densifying a row-sparse gradient in both packages; and a
mixed push whose dense keys still make one fused K1 call (counted on the
plain route) while the row-sparse key never reaches it."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.ndarray import sparse as sp

TOL = {"rtol": 1e-6, "atol": 1e-7}


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


def _rows(rs, n, nnz, width, dup=False):
    idx = rs.choice(n, nnz, replace=dup).astype(np.int64)
    return rs.randn(nnz, width).astype(np.float32), idx


def _both_rs(vals, idx, shape):
    return (sp.row_sparse_array((vals, idx), shape=shape),
            jsp.row_sparse_array((vals, idx), shape=shape))


@pytest.mark.parametrize("updater", [False, True])
def test_push_pull_and_row_sparse_pull_match_the_jax_local_store(updater):
    rs = np.random.RandomState(0)
    shape = (30, 4)
    kv, jkv = mx.kv.create("local"), jmx.kv.create("local")
    init = rs.randn(*shape).astype(np.float32)
    kv.init("emb", mx.nd.array(init))
    jkv.init("emb", jmx.nd.array(init))
    if updater:
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5,
                                             momentum=0.9, wd=0.01))
        jkv.set_optimizer(jmx.optimizer.create("sgd", learning_rate=0.5,
                                               momentum=0.9, wd=0.01))
    for rnd in range(3):
        parts = [_both_rs(*_rows(rs, 30, 6, 4), shape) for _ in range(3)]
        kv.push("emb", [p for p, _ in parts])
        jkv.push("emb", [j for _, j in parts])
        assert all(p._dense_cache is None for p, _ in parts)
        rows = np.unique(rs.choice(30, 8))
        out = sp.row_sparse_array((np.zeros((len(rows), 4), np.float32),
                                   rows), shape=shape)
        jout = jsp.row_sparse_array((np.zeros((len(rows), 4), np.float32),
                                     rows), shape=shape)
        kv.row_sparse_pull("emb", out=out, row_ids=mx.nd.array(rows))
        jkv.row_sparse_pull("emb", out=jout, row_ids=jmx.nd.array(rows))
        assert out._dense_cache is None
        np.testing.assert_array_equal(out.indices.asnumpy(),
                                      jout.indices.asnumpy().astype(np.int64))
        np.testing.assert_allclose(out.data.asnumpy(), jout.data.asnumpy(),
                                   **TOL)
        dense = mx.nd.ones(shape)
        jdense = jmx.nd.ones(shape)
        kv.row_sparse_pull("emb", out=dense, row_ids=mx.nd.array(rows))
        jkv.row_sparse_pull("emb", out=jdense, row_ids=jmx.nd.array(rows))
        np.testing.assert_allclose(dense.asnumpy(), jdense.asnumpy(), **TOL)
    full, jfull = mx.nd.zeros(shape), jmx.nd.zeros(shape)
    kv.pull("emb", out=full)
    jkv.pull("emb", out=jfull)
    np.testing.assert_allclose(full.asnumpy(), jfull.asnumpy(), **TOL)
    # a row-sparse out of a plain pull holds the whole value
    rs_out = sp.row_sparse_array((np.zeros((1, 4), np.float32), [0]),
                                 shape=shape)
    kv.pull("emb", out=rs_out)
    np.testing.assert_allclose(rs_out.asnumpy(), jfull.asnumpy(), **TOL)
    with pytest.raises(ValueError, match="row_ids"):
        kv.row_sparse_pull("emb", out=out)


def test_row_sparse_pull_of_several_keys_and_outs():
    kv = mx.kv.create("local")
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    kv.init(["a", "b"], [mx.nd.array(a), mx.nd.array(2 * a)])
    outs = [sp.row_sparse_array((np.zeros((2, 2), np.float32), [0, 1]),
                                shape=(6, 2)) for _ in range(2)]
    kv.row_sparse_pull(["a", "b"], out=outs, row_ids=mx.nd.array([5, 1]))
    np.testing.assert_array_equal(outs[0].data.asnumpy(), a[[5, 1]])
    np.testing.assert_array_equal(outs[1].data.asnumpy(), 2 * a[[5, 1]])
    np.testing.assert_array_equal(outs[1].indices.asnumpy(), [5, 1])


@pytest.mark.parametrize("cfg", [
    {},
    {"momentum": 0.9},
    {"momentum": 0.9, "wd": 0.05},
    {"wd": 0.1, "clip_gradient": 0.3},
    {"momentum": 0.5, "rescale_grad": 0.25, "clip_gradient": 0.2,
     "wd": 0.01},
])
def test_lazy_sgd_matches_jax_sparse_update(cfg):
    rs = np.random.RandomState(1)
    shape = (40, 5)
    w0 = rs.randn(*shape).astype(np.float32)
    opt = mx.optimizer.create("sgd", learning_rate=0.3, **cfg)
    jopt = jmx.optimizer.create("sgd", learning_rate=0.3, **cfg)
    w, jw = mx.nd.array(w0), jmx.nd.array(w0)
    st, jst = opt.create_state(0, w), jopt.create_state(0, jw)
    touched = set()
    for step in range(4):
        vals, idx = _rows(rs, 40, 7, 5, dup=step == 2)
        touched |= set(idx.tolist())
        g, jg = _both_rs(vals, idx, shape)
        opt.update(0, w, g, st)
        jopt.update(0, jw, jg, jst)
        np.testing.assert_allclose(w.asnumpy(), jw.asnumpy(), **TOL)
        if st is not None:
            np.testing.assert_allclose(st.asnumpy(), jst.asnumpy(), **TOL)
        assert g._dense_cache is None
    untouched = sorted(set(range(40)) - touched)
    np.testing.assert_array_equal(w.asnumpy()[untouched], w0[untouched])


def test_adam_densifies_a_row_sparse_gradient_as_jax_does():
    """Both packages update every row's moments (and so every row's
    weight once a moment is non-zero): MXNet 1.x's lazy Adam would leave
    untouched rows alone (ROADMAP.md C)."""
    rs = np.random.RandomState(2)
    shape = (12, 3)
    w0 = rs.randn(*shape).astype(np.float32)
    opt = mx.optimizer.create("adam", learning_rate=0.1, wd=0.1)
    jopt = jmx.optimizer.create("adam", learning_rate=0.1, wd=0.1)
    w, jw = mx.nd.array(w0), jmx.nd.array(w0)
    st, jst = opt.create_state(0, w), jopt.create_state(0, jw)
    for _ in range(2):
        g, jg = _both_rs(*_rows(rs, 12, 3, 3), shape)
        opt.update(0, w, g, st)
        jopt.update(0, jw, jg, jst)
    np.testing.assert_allclose(w.asnumpy(), jw.asnumpy(), rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
    assert (st[0].asnumpy() != 0).all()   # weight decay reached every row
    assert (w.asnumpy() != w0).all()


def test_mixed_push_keeps_one_fused_call_and_the_sparse_key_off_it(
        monkeypatch):
    entry = kernels.entry("opt_sgd")
    plain = entry.plain
    calls = []

    def counted(weights, grads, *args, **kwargs):
        calls.append([g.shape for g in grads])
        return plain(weights, grads, *args, **kwargs)

    monkeypatch.setattr(entry, "plain", counted)
    rs = np.random.RandomState(3)
    shapes = {"a": (5, 3), "emb": (50, 4), "b": (7,), "c": (2, 2)}
    kv, jkv = mx.kv.create("local"), jmx.kv.create("local")
    for k, s in shapes.items():
        v = rs.randn(*s).astype(np.float32)
        kv.init(k, mx.nd.array(v))
        jkv.init(k, jmx.nd.array(v))
    kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}
    kv.set_optimizer(mx.optimizer.create("sgd", **kw))
    jkv.set_optimizer(jmx.optimizer.create("sgd", **kw))
    for _ in range(2):
        grads, jgrads = [], []
        for k, s in shapes.items():
            if k == "emb":
                g, jg = _both_rs(*_rows(rs, 50, 6, 4), s)
            else:
                v = rs.randn(*s).astype(np.float32)
                g, jg = mx.nd.array(v), jmx.nd.array(v)
            grads.append(g)
            jgrads.append(jg)
        kv.push(list(shapes), grads)
        for k, jg in zip(shapes, jgrads):   # the JAX store updates by key
            jkv.push(k, jg)
        assert grads[1]._dense_cache is None
    assert calls == [[(5, 3), (7,), (2, 2)]] * 2
    for k, s in shapes.items():
        got, want = mx.nd.zeros(s), jmx.nd.zeros(s)
        kv.pull(k, out=got)
        jkv.pull(k, out=want)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)


def test_updater_update_multi_routes_row_sparse_gradients():
    opt = mx.optimizer.create("sgd", learning_rate=1.0, momentum=0.5)
    upd = mx.optimizer.get_updater(opt)
    w = [mx.nd.ones((4, 2)), mx.nd.ones((3,))]
    g = [sp.row_sparse_array((np.ones((1, 2), np.float32), [2]),
                             shape=(4, 2)), mx.nd.ones((3,))]
    upd.update_multi([0, 1], g, w)
    upd.update_multi([0, 1], g, w)
    np.testing.assert_allclose(w[0].asnumpy()[[0, 1, 3]], 1.0)
    np.testing.assert_allclose(w[0].asnumpy()[2], [1 - 1 - 1.5] * 2)
    np.testing.assert_allclose(w[1].asnumpy(), [1 - 1 - 1.5] * 3)
    # lazy_update=False densifies, as the JAX SGD does: every row moves
    opt2 = mx.optimizer.create("sgd", learning_rate=1.0, wd=0.5,
                               lazy_update=False)
    w2 = mx.nd.ones((4, 2))
    opt2.update(0, w2, g[0], None)
    np.testing.assert_allclose(w2.asnumpy()[0], [0.5, 0.5])


def test_sparse_embedding_grad_rows_and_parameter_stype():
    emb = mx.gluon.contrib.nn.SparseEmbedding(20, 3)
    emb.initialize(mx.init.Uniform(0.1), ctx=mx.cpu())
    x = mx.nd.array(np.array([[3, 7, 3], [1, 7, 0]], np.float32))
    with mx.autograd.record():
        y = emb(x).sum()
    y.backward()
    rows = emb.grad_rows(x)
    assert rows.stype == "row_sparse"
    np.testing.assert_array_equal(rows.indices.asnumpy(), [0, 1, 3, 7])
    dense = emb.weight.grad().asnumpy()
    np.testing.assert_array_equal(rows.data.asnumpy(), dense[[0, 1, 3, 7]])
    np.testing.assert_array_equal(rows.asnumpy(), dense)
    p = mx.gluon.Parameter("w", shape=(2, 2), stype="row_sparse",
                           grad_stype="row_sparse")
    assert p.shape == (2, 2)
    e = mx.gluon.nn.Embedding(10, 4, sparse_grad=True)
    e.initialize(ctx=mx.cpu())
    with mx.autograd.record():
        out = e(mx.nd.array([1.0, 2.0])).sum()
    out.backward()
    g = e.weight.grad()
    assert g.stype == "default" and g.shape == (10, 4)
