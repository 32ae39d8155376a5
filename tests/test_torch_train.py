"""The port's training slice on the CPU against the JAX package: the
fine-tune of examples/gluon/transformer_finetune.py (the example's small
config) through ShardedTrainer on DeviceMesh({"dp": 1}) in both packages
from the same weights, for "adam" and "sgd" with momentum; the loss, the
autograd scopes, the non-finite guard and the options this slice does not
port yet."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import build_classifier, random_params
from mxnet_tpu.parallel import DeviceMesh as JaxMesh
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu_torch.convert import export_params, load_jax_params
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

ROOT = Path(__file__).resolve().parents[1]
# the example's defaults, with its 4 classes and a batch of 8
SMALL = {"vocab": 64, "units": 32, "hidden": 64, "heads": 4, "layers": 2,
         "seq_len": 16, "num_classes": 4}
BATCH, STEPS = 8, 3
CPU = mx.cpu()
# one step's loss, float32 on the CPU in both frameworks (different
# summation orders in the GEMMs and reductions)
LOSS_RTOL = 1e-5
OPTIMIZERS = {
    "adam": {"learning_rate": 1e-3, "wd": 1e-4},
    "sgd": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
}


def _make_task():
    spec = importlib.util.spec_from_file_location(
        "transformer_finetune",
        ROOT / "examples" / "gluon" / "transformer_finetune.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_task(BATCH * STEPS, SMALL["seq_len"], SMALL["vocab"],
                         SMALL["num_classes"], seed=5)


@pytest.fixture(scope="module")
def task():
    return _make_task()


def _port_trainer(weights, optimizer, params):
    clf = build_classifier(mx, SMALL)
    clf.initialize(ctx=CPU)
    load_jax_params(clf, weights)
    st = ShardedTrainer(clf, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                        optimizer, dict(params),
                        mesh=DeviceMesh({"dp": 1}, devices=[CPU]))
    return clf, st


def _jax_trainer(weights, optimizer, params, x):
    clf = build_classifier(jmx, SMALL)
    clf.initialize(jmx.init.Xavier())
    clf(jmx.nd.array(x[:2]))  # resolve deferred shapes
    for name, p in clf._collect_params_with_structure().items():
        p.set_data(jmx.nd.array(weights[name]))
    st = JaxTrainer(clf, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
                    dict(params), mesh=JaxMesh({"dp": 1}))
    return clf, st


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_fine_tune_steps_match_jax_sharded_trainer(task, optimizer):
    """Three steps on three batches: each step's loss within rtol 1e-5,
    every parameter after the last within atol 1e-2 * lr (Adam's first
    steps move each weight by about lr, whatever the gradient's size, so
    the bound is a hundredth of one step). One exception, argued: the
    attention key biases have a true gradient of exactly zero (a bias on
    every key adds the same q.b to a whole row of scores, and softmax is
    shift-invariant), so each package computes rounding noise there,
    which Adam scales up to steps of about lr; they are held to 1 * lr
    (SGD keeps them within 1e-2 * lr like the rest)."""
    x, y = task
    params = OPTIMIZERS[optimizer]
    weights = random_params(SMALL, seed=0)
    clf, st = _port_trainer(weights, optimizer, params)
    jclf, jst = _jax_trainer(weights, optimizer, params, x)
    for i in range(STEPS):
        xb, yb = x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH]
        got = st.step(mx.nd.array(xb, ctx=CPU),
                      mx.nd.array(yb, ctx=CPU)).asscalar()
        want = jst.step(jmx.nd.array(xb), jmx.nd.array(yb)).asscalar()
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert st.skipped_steps == 0
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
    pred = st.predict(mx.nd.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(pred, jst.predict(jmx.nd.array(x)).asnumpy(),
                               rtol=1e-4, atol=1e-5)


def test_fine_tune_loss_falls_and_weight_decay_skips_biases(task):
    x, y = task
    weights = random_params(SMALL, seed=0)
    clf, st = _port_trainer(weights, "adam", {"learning_rate": 1e-2,
                                              "wd": 1e-4})
    losses = [st.step(mx.nd.array(x[:BATCH], ctx=CPU),
                      mx.nd.array(y[:BATCH], ctx=CPU)).asscalar()
              for _ in range(5)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    wd_of = dict(zip(st._param_names, st._wd_mult))
    assert all(wd_of[n] == (1.0 if n.endswith(("weight", "gamma")) else 0.0)
               for n in wd_of)
    assert wd_of[next(n for n in wd_of if n.endswith("beta"))] == 0.0
    assert st.learning_rate == 1e-2
    st.learning_rate = 5e-3
    assert st.learning_rate == 5e-3


def _dense_trainer(**kw):
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(mx.init.Xavier(), ctx=CPU,
                   generator=torch.Generator().manual_seed(0))
    return net, ShardedTrainer(net, mx.gluon.loss.L2Loss(), "adam",
                               {"learning_rate": 0.1},
                               mesh=DeviceMesh({"dp": 1}, devices=[CPU]),
                               **kw)


def test_nan_guard_skips_the_update_and_counts():
    net, st = _dense_trainer(max_consecutive_skips=2)
    rs = np.random.RandomState(0)
    x = rs.randn(6, 4).astype(np.float32)
    y = rs.randn(6, 3).astype(np.float32)
    st.step(x, y)
    before = [h._data.clone() for h in st._train_handles]
    state = [s.clone() for per in st._opt_state for s in per]
    bad = x.copy()
    bad[2, 1] = np.nan
    loss = st.step(bad, y).asscalar()
    assert np.isnan(loss)
    assert st.skipped_steps == 1 and st.consecutive_skips == 1
    for a, b in zip(before, [h._data for h in st._train_handles]):
        assert torch.equal(a, b)
    for a, b in zip(state, [s for per in st._opt_state for s in per]):
        assert torch.equal(a, b)
    st.step(x, y)
    assert st.consecutive_skips == 0 and st.skipped_steps == 1
    assert not torch.equal(before[0], st._train_handles[0]._data)
    st.step(bad, y)
    with pytest.raises(RuntimeError, match="consecutive"):
        st.step(bad, y)
    assert st.skipped_steps == 3


def test_sgd_without_momentum_and_an_optimizer_instance():
    net, _ = _dense_trainer()
    opt = mx.optimizer.SGD(learning_rate=0.2, wd=0.0)
    st = ShardedTrainer(net, mx.gluon.loss.L2Loss(), opt,
                        mesh=DeviceMesh({"dp": 1}, devices=[CPU]))
    assert st.learning_rate == 0.2 and st._opt_state[0] == ()
    x = np.ones((2, 4), np.float32)
    y = np.zeros((2, 3), np.float32)
    w = net.weight.data()._data.clone()
    b = net.bias.data()._data.clone()
    with mx.autograd.record():
        xa = mx.nd.array(x, ctx=CPU)
        loss = mx.gluon.loss.L2Loss()(net(xa), mx.nd.array(y, ctx=CPU))
    pred = xa._data @ w.T + b
    grad_w = (pred.T @ xa._data) / 2   # d mean_b(0.5 mean_j pred^2) / dW
    st.step(x, y)
    torch.testing.assert_close(net.weight.data()._data, w - 0.2 * grad_w / 3,
                               rtol=1e-6, atol=1e-7)
    assert loss.shape == (2,)


# remat and accum_steps are ported (tests/test_torch_transformer_lm.py);
# zero, donate=False and sharding rules are ported too
# (tests/test_torch_trainer_options.py): on a mesh of one device each
# builds a trainer, and a rule naming an axis the mesh lacks raises,
# naming the parameter. The cases keep their ids.
@pytest.mark.parametrize("kwargs,match", [
    pytest.param({"zero": True}, None, id="kwargs0-zero"),
    pytest.param({"donate": False}, None, id="kwargs3-donate"),
    pytest.param({"rules": {"weight": ("tp",)}}, "axis 'tp' is not an axis",
                 id="kwargs4-rules"),
])
def test_unported_trainer_options_raise(kwargs, match):
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=CPU)
    mesh = DeviceMesh({"dp": 1}, devices=[CPU])
    if match is not None:
        name = next(iter(net.collect_params()))
        with pytest.raises(ValueError, match=match):
            ShardedTrainer(net, mx.gluon.loss.L2Loss(), mesh=mesh,
                           rules={name: kwargs["rules"]["weight"]})
        return
    st = ShardedTrainer(net, mx.gluon.loss.L2Loss(), mesh=mesh, **kwargs)
    assert st.topology_meta()["zero"] is bool(kwargs.get("zero", False))
    st.step(np.ones((2, 4), np.float32), np.zeros((2, 3), np.float32))
    assert st._t == 1


def test_unported_optimizers_meshes_and_methods_raise():
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=CPU)
    mesh = DeviceMesh({"dp": 1}, devices=[CPU])
    # every optimizer of the JAX zoo has its rule now
    # (tests/test_torch_opt_rules.py)
    assert ShardedTrainer(net, mx.gluon.loss.L2Loss(), "rmsprop",
                          mesh=mesh)._opt_name == "rmsprop"
    with pytest.raises(ValueError, match="Cannot find"):
        ShardedTrainer(net, mx.gluon.loss.L2Loss(), "no-such", mesh=mesh)
    with pytest.raises(mx.MXNetError, match="NCCL"):
        DeviceMesh({"dp": 2}, devices=[CPU, mx.cpu(1)])
    with pytest.raises(ValueError, match="require 2 devices"):
        DeviceMesh({"dp": 2}, devices=[CPU])
    st = ShardedTrainer(net, mx.gluon.loss.L2Loss(), mesh=mesh)
    # aot_lower and warmup are ported (tests/test_torch_trainer_options.py)
    spec = ((2, 4), "float32"), ((2, 3), "float32")
    assert "aten" in st.aot_lower(*spec).as_text()
    assert st.warmup(*spec)["entries"] == 0 and st._t == 0
    # publish_to / publish_update are ported (tests/test_torch_modelbus.py);
    # the eager Optimizer.update is ported (tests/test_torch_trainer.py);
    # so is the dist_async kvstore (tests/test_torch_sparse_dist.py). lr
    # schedulers, multi_precision, bfloat16 parameters and checkpoints
    # are ported (tests/test_torch_lr_scheduler.py,
    # test_torch_multi_precision.py, test_torch_checkpoint.py)
    kv = mx.kv.create("dist_async")
    assert (kv.type, kv.num_workers) == ("dist_async", 1)


def test_mesh_defaults_to_the_card_and_to_the_cpu_scope(monkeypatch):
    with mx.cpu():
        mesh = DeviceMesh()
    assert mesh.device == torch.device("cpu") and mesh.size("dp") == 1
    assert mesh.size("tp") == 1 and mesh.num_devices == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(mx.MXNetError, match="CUDA card"):
        DeviceMesh({"dp": 1})


def test_softmax_cross_entropy_matches_jax():
    rs = np.random.RandomState(3)
    pred = rs.randn(5, 4).astype(np.float32)
    label = np.array([0, 3, 1, 2, 3], np.float32)
    dense = np.eye(4, dtype=np.float32)[label.astype(int)]
    weight = rs.rand(5, 1).astype(np.float32)
    for kw, lab, sw in (({}, label, None), ({"sparse_label": False}, dense,
                                            None),
                        ({"weight": 0.5}, label, weight)):
        jl = jmx.gluon.loss.SoftmaxCrossEntropyLoss(**kw)
        pl = mx.gluon.loss.SoftmaxCrossEntropyLoss(**kw)
        jargs = [jmx.nd.array(a) for a in (pred, lab)] + (
            [jmx.nd.array(sw)] if sw is not None else [])
        pargs = [mx.nd.array(a, ctx=CPU) for a in (pred, lab)] + (
            [mx.nd.array(sw, ctx=CPU)] if sw is not None else [])
        np.testing.assert_allclose(pl(*pargs).asnumpy(),
                                   jl(*jargs).asnumpy(), rtol=1e-6,
                                   atol=1e-6)
    got = mx.gluon.loss.L2Loss()(mx.nd.array(pred, ctx=CPU),
                                 mx.nd.array(dense, ctx=CPU)).asnumpy()
    want = jmx.gluon.loss.L2Loss()(jmx.nd.array(pred),
                                   jmx.nd.array(dense)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_autograd_record_backward_and_grad_match_jax():
    rs = np.random.RandomState(4)
    a = rs.randn(3, 4).astype(np.float32)
    b = rs.randn(3, 4).astype(np.float32)

    def f(pkg, x, y):
        z = pkg.nd.invoke("log_softmax", x * y - x, axis=-1)
        return (-z).mean()

    jx, jy = jmx.nd.array(a), jmx.nd.array(b)
    jx.attach_grad()
    jy.attach_grad()
    with jmx.autograd.record():
        jout = f(jmx, jx, jy)
    jout.backward()
    px, py = mx.nd.array(a, ctx=CPU), mx.nd.array(b, ctx=CPU)
    px.attach_grad()
    py.attach_grad()
    assert not mx.autograd.is_recording()
    with mx.autograd.record():
        assert mx.autograd.is_recording() and mx.autograd.is_training()
        pout = f(mx, px, py)
    pout.backward()
    np.testing.assert_allclose(pout.asscalar(), jout.asscalar(), rtol=1e-6)
    for p, j in ((px, jx), (py, jy)):
        np.testing.assert_allclose(p.grad.asnumpy(), j.grad.asnumpy(),
                                   rtol=1e-5, atol=1e-7)
    # "write" overwrites, "add" accumulates
    with mx.autograd.record():
        pout = f(mx, px, py)
    pout.backward()
    np.testing.assert_allclose(px.grad.asnumpy(), jx.grad.asnumpy(),
                               rtol=1e-5, atol=1e-7)
    px.attach_grad("add")
    for _ in range(2):
        with mx.autograd.record():
            f(mx, px, py).backward()
    np.testing.assert_allclose(px.grad.asnumpy(), 2 * jx.grad.asnumpy(),
                               rtol=1e-5, atol=1e-7)
    with mx.autograd.record():
        out = f(mx, px, py)
    gx, = mx.autograd.grad(out, [px])
    np.testing.assert_allclose(gx.asnumpy(), jx.grad.asnumpy(), rtol=1e-5,
                               atol=1e-7)
    with mx.autograd.pause():
        assert not torch.is_grad_enabled()
        with pytest.raises(ValueError, match="record"):
            f(mx, mx.nd.array(a, ctx=CPU), py).backward()


def test_export_params_is_the_inverse_of_load_jax_params():
    weights = random_params(SMALL, seed=2)
    clf = build_classifier(mx, SMALL)
    clf.initialize(ctx=CPU)
    load_jax_params(clf, weights)
    out = export_params(clf)
    assert set(out) == set(weights)
    for name, value in weights.items():
        assert np.array_equal(out[name], value)
