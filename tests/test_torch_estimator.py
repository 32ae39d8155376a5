"""The port's ``gluon.contrib.estimator`` against the JAX package's: the
preemption drill of ``tests/test_elastic.py`` (a drain requested before
``fit``: ``SystemExit(75)`` after a mid-epoch checkpoint) run in both
packages from the same numpy weights, each package reading the other's
parameters file; ``fit``/``evaluate`` with the stock handlers; resuming
from a checkpoint; and the card default of ``context=None``."""
import json
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import preempt as jpreempt
from mxnet_tpu_torch import preempt

from _torch_lifecycle import CPU, lifecycle_clean  # noqa: F401

RS = np.random.RandomState(0)
WEIGHT = RS.randn(3, 5).astype(np.float32) * 0.3
BIAS = RS.randn(3).astype(np.float32) * 0.1
DATA = [(RS.randn(4, 5).astype(np.float32),
         RS.randint(0, 3, 4).astype(np.float32)) for _ in range(4)]


def _setup(pkg, ctx, lr=0.05):
    from importlib import import_module

    est_mod = import_module(pkg.__name__ + ".gluon.contrib.estimator")
    net = pkg.gluon.nn.Dense(3, in_units=5)
    net.initialize(pkg.init.Zero(), ctx=ctx)
    net.weight.set_data(pkg.nd.array(WEIGHT, ctx=ctx))
    net.bias.set_data(pkg.nd.array(BIAS, ctx=ctx))
    data = [(pkg.nd.array(x, ctx=ctx), pkg.nd.array(y, ctx=ctx))
            for x, y in DATA]
    est = est_mod.Estimator(
        net, pkg.gluon.loss.SoftmaxCrossEntropyLoss(), context=ctx,
        trainer=pkg.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": lr}))
    return est_mod, net, data, est


def _params(net):
    return {k: p.data().asnumpy().copy()
            for k, p in net._collect_params_with_structure().items()}


def _drill(pkg, pre, ctx, tmp):
    est_mod, net, data, est = _setup(pkg, ctx)
    handler = est_mod.CheckpointHandler(str(tmp), model_prefix="m",
                                        max_checkpoints=3)
    pre.request("estimator-drill")
    try:
        with pytest.raises(SystemExit) as exc:
            est.fit(data, epochs=3, event_handlers=[handler])
    finally:
        pre.clear()
    manifest = json.loads((tmp / "MANIFEST.json").read_text())
    return exc.value.code, _params(net), manifest["checkpoints"]


def test_estimator_drain_drill_matches_jax_and_files_cross(tmp_path):
    code, got, entries = _drill(mx, preempt, CPU, tmp_path / "port")
    jcode, want, jentries = _drill(jmx, jpreempt, jmx.cpu(),
                                   tmp_path / "jax")
    assert code == jcode == 75
    assert [e["epoch"] for e in entries] == [e["epoch"] for e in jentries] \
        == [1]   # a mid-epoch-1 drain: one batch trained
    entry, jentry = entries[-1], jentries[-1]
    assert set(entry) == set(jentry)
    assert set(entry["files"]) == set(jentry["files"]) == {"params"}
    assert entry["meta"]["drain"]["reason"] == \
        jentry["meta"]["drain"]["reason"] == "estimator-drill"
    assert set(entry["meta"]["drain"]) == set(jentry["meta"]["drain"])
    assert (tmp_path / "port" / "m-0001.params").exists()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)
    # each package reads the other's parameters file
    jnet = jmx.gluon.nn.Dense(3, in_units=5)
    jnet.initialize(jmx.init.Zero())
    jnet.load_parameters(str(tmp_path / "port" / "m-0001.params"))
    net = mx.gluon.nn.Dense(3, in_units=5)
    net.initialize(mx.init.Zero(), ctx=CPU)
    net.load_parameters(str(tmp_path / "jax" / "m-0001.params"))
    for k in want:
        np.testing.assert_array_equal(_params(jnet)[k], got[k])
        np.testing.assert_array_equal(_params(net)[k], want[k])


def test_drain_resumes_through_checkpoint_handler(tmp_path):
    code, drained, _ = _drill(mx, preempt, CPU, tmp_path)
    est_mod, net, data, est = _setup(mx, CPU)
    handler = est_mod.CheckpointHandler(str(tmp_path), model_prefix="m",
                                        resume_from_checkpoint=True)
    handler.train_begin(est)
    assert handler.current_epoch == handler.trained_epochs == 1
    for k, v in _params(net).items():
        np.testing.assert_array_equal(v, drained[k])


def _fit(pkg, ctx, tmp, caplog=None):
    est_mod, net, data, est = _setup(pkg, ctx)
    stop = est_mod.EarlyStoppingHandler(est.train_loss_metric, patience=0,
                                        mode="max")
    handlers = [est_mod.CheckpointHandler(str(tmp), model_prefix="f"),
                stop, est_mod.LoggingHandler(log_interval=2,
                                             metrics=est.train_metrics)]
    est.fit(data, val_data=data, epochs=4, event_handlers=handlers)
    val = est.evaluate(data)
    return (_params(net), [m.get() for m in est.train_metrics],
            est.train_loss_metric.get(), val, stop.stopped_epoch)


def test_fit_with_handlers_and_evaluate_match_jax(tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="Estimator"):
        got = _fit(mx, CPU, tmp_path / "port")
    logged = [r.getMessage() for r in caplog.records]
    want = _fit(jmx, jmx.cpu(), tmp_path / "jax")
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5,
                                   atol=1e-6)
    assert [n for n, _ in got[1]] == [n for n, _ in want[1]]
    np.testing.assert_allclose([v for _, v in got[1]],
                               [v for _, v in want[1]], rtol=1e-5)
    assert got[2][0] == want[2][0]
    np.testing.assert_allclose(got[2][1], want[2][1], rtol=1e-5)
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        np.testing.assert_allclose(got[3][k], want[3][k], rtol=1e-5)
    # the falling loss never "improves" in max mode: stopped at epoch 2
    assert got[4] == want[4] == 2
    assert any(m.startswith("[Batch 2]") for m in logged)
    manifest = json.loads((tmp_path / "port" / "MANIFEST.json").read_text())
    assert [e["epoch"] for e in manifest["checkpoints"]] == [1, 2]


def test_context_none_is_the_card(monkeypatch):
    from mxnet_tpu_torch import context
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon.contrib.estimator import Estimator

    net = mx.gluon.nn.Dense(3, in_units=5)
    net.initialize(mx.init.Zero(), ctx=CPU)
    monkeypatch.setattr(context, "num_gpus", lambda: 0)
    with pytest.raises(MXNetError, match=r"gpu\(0\)"):
        Estimator(net, mx.gluon.loss.L2Loss())
    monkeypatch.setattr(context, "num_gpus", lambda: 1)
    card = mx.Context("cpu", 7)   # stands for gpu(0) here
    monkeypatch.setattr(context, "gpu", lambda i=0: card if i == 0 else None)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    est = Estimator(net, mx.gluon.loss.L2Loss(), trainer=trainer)
    assert est.context == [card]
    assert Estimator(net, mx.gluon.loss.L2Loss(), trainer=trainer,
                     context=CPU).context == [CPU]
