"""The port's eager ``gluon.Trainer`` and ``Optimizer.update`` against the
JAX package's on the CPU: the fine-tune classifier of
examples/gluon/transformer_finetune.py (the example's small config)
trained 3 steps with ``autograd.record()`` / ``backward()`` /
``trainer.step()`` in both packages from the same weights, for "sgd"
with momentum and "adam"; the gradient buffers of Parameters; the
stale-gradient check; lr_mult and wd_mult; save_states / load_states."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import build_classifier, random_params
from mxnet_tpu_torch.convert import export_params, load_jax_params

SMALL = {"vocab": 64, "units": 32, "hidden": 64, "heads": 4, "layers": 2,
         "seq_len": 16, "num_classes": 4}
BATCH, STEPS = 8, 3
CPU = mx.cpu()
LOSS_RTOL = 1e-5   # float32 on the CPU; the frameworks sum in other orders
OPTIMIZERS = {
    "adam": {"learning_rate": 1e-3, "wd": 1e-4},
    "sgd": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
}


def _task():
    rs = np.random.RandomState(5)
    x = rs.randint(0, SMALL["vocab"], (BATCH * STEPS, SMALL["seq_len"]))
    y = rs.randint(0, SMALL["num_classes"], BATCH * STEPS)
    return x.astype(np.float32), y.astype(np.float32)


def _port_classifier(weights):
    clf = build_classifier(mx, SMALL)
    clf.initialize(ctx=CPU)
    load_jax_params(clf, weights)
    return clf


def _jax_classifier(weights, x):
    clf = build_classifier(jmx, SMALL)
    clf.initialize(jmx.init.Xavier())
    clf(jmx.nd.array(x[:2]))  # resolve deferred shapes
    for name, p in clf._collect_params_with_structure().items():
        p.set_data(jmx.nd.array(weights[name]))
    return clf


def _step(pkg, clf, trainer, x, y, **ctx):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record():
        loss = loss_fn(clf(pkg.nd.array(x, **ctx)), pkg.nd.array(y, **ctx))
    loss.backward()
    trainer.step(x.shape[0])
    return float(loss.mean().asscalar())


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_trainer_steps_match_the_jax_trainer(optimizer):
    """Three steps with kvstore="device" (no store): each step's loss
    within rtol 1e-5, every parameter after the last within atol 1e-2 *
    lr, except the attention key biases under Adam, held to 1 * lr: their
    true gradient is zero (softmax is shift-invariant along a row), so
    each package steps on its own rounding noise (tests/test_torch_train.py
    argues the same bound for the ShardedTrainer)."""
    x, y = _task()
    params = OPTIMIZERS[optimizer]
    weights = random_params(SMALL, seed=0)
    clf, jclf = _port_classifier(weights), _jax_classifier(weights, x)
    tr = mx.gluon.Trainer(clf.collect_params(), optimizer, dict(params))
    jtr = jmx.gluon.Trainer(jclf.collect_params(), optimizer, dict(params))
    for i in range(STEPS):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        got = _step(mx, clf, tr, x[sl], y[sl], ctx=CPU)
        want = _step(jmx, jclf, jtr, x[sl], y[sl])
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert tr._kvstore is None and tr.learning_rate == params["learning_rate"]
    got = export_params(clf)
    want = {n: p.data().asnumpy()
            for n, p in jclf._collect_params_with_structure().items()}
    assert set(got) == set(want)
    lr = params["learning_rate"]
    for name in want:
        noise = optimizer == "adam" and name.endswith("attn.key.bias")
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=(1.0 if noise else 1e-2) * lr,
                                   err_msg=name)


def test_trainer_with_a_local_store_equals_no_store():
    """kvstore=KVStore("local") pushes and pulls every gradient (one
    worker: the pull is the push); the weights end bit-identical to the
    trainer without a store."""
    x, y = _task()
    weights = random_params(SMALL, seed=1)
    runs = []
    for kv in (None, mx.kv.create("local")):
        clf = _port_classifier(weights)
        tr = mx.gluon.Trainer(clf.collect_params(), "adam",
                              {"learning_rate": 1e-3},
                              kvstore=kv if kv is not None else "device")
        for i in range(2):
            sl = slice(i * BATCH, (i + 1) * BATCH)
            _step(mx, clf, tr, x[sl], y[sl], ctx=CPU)
        runs.append(export_params(clf))
    for name in runs[0]:
        np.testing.assert_array_equal(runs[0][name], runs[1][name])


class _TwoBranch(mx.gluon.Block):
    def __init__(self, pkg, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.a = pkg.gluon.nn.Dense(2, in_units=3)
            self.b = pkg.gluon.nn.Dense(2, in_units=3)

    def forward(self, x):
        return self.a(x)


class _JaxTwoBranch(jmx.gluon.Block):
    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.a = jmx.gluon.nn.Dense(2, in_units=3)
            self.b = jmx.gluon.nn.Dense(2, in_units=3)

    def forward(self, x):
        return self.a(x)


def test_stale_gradient_raises_and_ignore_stale_grad_skips():
    """A parameter the forward did not use has no fresh gradient: step
    raises UserWarning, as in both MXNet 1.x and the JAX package;
    ignore_stale_grad=True updates only the fresh ones."""
    x = np.ones((4, 3), np.float32)
    for pkg, net, ctx in ((mx, _TwoBranch(mx), {"ctx": CPU}),
                          (jmx, _JaxTwoBranch(), {})):
        net.initialize(**ctx)
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        for _ in range(2):
            # the refused step has consumed the fresh gradient of a
            # (both packages check in parameter order): backward again
            with pkg.autograd.record():
                loss = net(pkg.nd.array(x, **ctx)).sum()
            loss.backward()
            if _ == 0:
                with pytest.raises(UserWarning, match="stale"):
                    tr.step(4)
        b_before = net.b.weight.data().asnumpy().copy()
        a_before = net.a.weight.data().asnumpy().copy()
        tr.step(4, ignore_stale_grad=True)
        np.testing.assert_array_equal(net.b.weight.data().asnumpy(),
                                      b_before)
        assert not np.array_equal(net.a.weight.data().asnumpy(), a_before)
        # the used gradient is stale now too
        with pytest.raises(UserWarning, match="stale"):
            tr.step(4)


def test_parameter_gradient_buffers():
    """grad() is zeros before the first backward; backward writes it
    (grad_req "write") or adds to it ("add"); zero_grad keeps the
    buffer; the data itself never requires grad."""
    net = mx.gluon.nn.Dense(2, in_units=3, use_bias=False)
    net.initialize(ctx=CPU)
    w = net.weight
    assert not w.data()._data.requires_grad
    assert torch.equal(w.grad()._data, torch.zeros(2, 3))
    x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=CPU)
    for _ in range(2):
        with mx.autograd.record():
            out = net(x)
        out.backward()
    want = x.asnumpy().sum(0, keepdims=True).repeat(2, 0)
    np.testing.assert_array_equal(w.grad().asnumpy(), want)
    assert w.list_grad()[0].shape == (2, 3)
    w.grad_req = "add"
    with mx.autograd.record():
        out = net(x)
    out.backward()
    np.testing.assert_array_equal(w.grad().asnumpy(), 2 * want)
    buf = w.grad()._data
    net.collect_params().zero_grad()
    assert torch.equal(w.grad()._data, torch.zeros(2, 3))
    assert w.grad()._data.data_ptr() == buf.data_ptr()
    w.set_data(np.ones((2, 3), np.float32))   # the buffer stays
    assert w.grad()._data.data_ptr() == buf.data_ptr()
    w.grad_req = "null"
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        w.grad()


def test_lr_mult_and_wd_mult_match_jax():
    """Per-parameter multipliers: two learning rates mean two launches
    of the fused update (here two calls of its plain version)."""
    x = np.random.RandomState(2).randn(4, 3).astype(np.float32)
    outs = []
    for pkg, ctx in ((mx, {"ctx": CPU}), (jmx, {})):
        net = pkg.gluon.nn.Dense(2, in_units=3)
        net.initialize(pkg.init.One(), **ctx)
        net.weight.lr_mult = 0.5
        net.bias.wd_mult = 0.0
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 0.01})
        for _ in range(2):
            with pkg.autograd.record():
                loss = (net(pkg.nd.array(x, **ctx)) *
                        net(pkg.nd.array(x, **ctx))).sum()
            loss.backward()
            tr.step(4)
        outs.append([net.weight.data().asnumpy(), net.bias.data().asnumpy()])
    for got, want in zip(*outs):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
             "clip_gradient": 0.5, "rescale_grad": 0.5}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3, "clip_gradient": 0.5}),
])
def test_optimizer_update_matches_jax(optimizer, params):
    """The eager per-parameter update with its own state, three times,
    against the JAX package's (float32, to 1e-6)."""
    rs = np.random.RandomState(3)
    w0 = rs.randn(6, 5).astype(np.float32)
    opt = mx.optimizer.create(optimizer, **params)
    jopt = jmx.optimizer.create(optimizer, **params)
    w, jw = mx.nd.array(w0, ctx=CPU), jmx.nd.array(w0)
    st, jst = opt.create_state(0, w), jopt.create_state(0, jw)
    for _ in range(3):
        g = rs.randn(6, 5).astype(np.float32)
        opt.update(0, w, mx.nd.array(g, ctx=CPU), st)
        jopt.update(0, jw, jmx.nd.array(g), jst)
    np.testing.assert_allclose(w.asnumpy(), jw.asnumpy(), rtol=1e-6,
                               atol=1e-7)
    assert opt.num_update == jopt.num_update == 3


def test_array_and_asnumpy_copy_on_the_cpu_as_in_mxnet():
    """``nd.array`` copies its numpy source and ``asnumpy`` returns a
    copy, on the CPU too, so updates in place (the optimizer, copyto)
    write into neither."""
    src = np.ones((2, 3), np.float32)
    w = mx.nd.array(src, ctx=CPU)
    before = w.asnumpy()
    mx.optimizer.create("sgd", learning_rate=0.5).update(
        0, w, mx.nd.array(np.ones((2, 3), np.float32), ctx=CPU), None)
    np.testing.assert_array_equal(w.asnumpy(), np.full((2, 3), 0.5))
    mx.nd.array(np.full((2, 3), 7.0), ctx=CPU).copyto(w)
    np.testing.assert_array_equal(w.asnumpy(), np.full((2, 3), 7.0))
    np.testing.assert_array_equal(src, np.ones((2, 3)))
    np.testing.assert_array_equal(before, np.ones((2, 3)))


def test_save_and_load_states_roundtrip(tmp_path):
    x, y = _task()
    weights = random_params(SMALL, seed=2)
    clf = _port_classifier(weights)
    tr = mx.gluon.Trainer(clf.collect_params(), "adam",
                          {"learning_rate": 1e-3})
    _step(mx, clf, tr, x[:BATCH], y[:BATCH], ctx=CPU)
    tr.save_states(str(tmp_path / "t.states"))
    saved = [tuple(s._data.clone() for s in st) for st in tr._states]
    _step(mx, clf, tr, x[BATCH:2 * BATCH], y[BATCH:2 * BATCH], ctx=CPU)
    tr.load_states(str(tmp_path / "t.states"))
    for got, want in zip(tr._states, saved):
        assert all(torch.equal(a._data, b) for a, b in zip(got, want))
    assert tr.optimizer._index_update_count[0] == 1
    tr.learning_rate = 5e-4
    assert tr.learning_rate == 5e-4


def test_compression_params_are_kept_not_applied():
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=CPU)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          compression_params={"type": "2bit"})
    assert tr._compression_params == {"type": "2bit"}
    with pytest.raises(ValueError, match="Parameters"):
        mx.gluon.Trainer([object()], "sgd")
    with pytest.raises(ValueError, match="optimizer_params"):
        mx.gluon.Trainer(net.collect_params(), mx.optimizer.SGD(),
                         {"learning_rate": 0.1})
