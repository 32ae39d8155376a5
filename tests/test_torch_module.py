"""The port's Module path (mxnet_tpu_torch/module, model.FeedForward,
callback, monitor, the local kvstore's batched push and pull) against
the JAX package's on the CPU.

Every parity case passes ``rescale_grad`` (or an optimizer object)
explicitly to both packages: with an optimizer name and no
``rescale_grad`` the port follows MXNet 1.x (``1 / batch_size``) and the
JAX Module does not (fault C8, asserted on its own below).

The thumbnail resnet18_v1 step is held as ``tests/
test_torch_resnet_train.py`` holds the trainer's: the port's weights,
momenta and running statistics are set to the JAX Module's before each
step (float32 ReLU kinks make any two implementations' gradients differ
by a few percent in a few tensors), the outputs and running statistics
to 1e-5, every weight and momentum within 5% of the L2 norm of the JAX
step for that tensor (its new momentum)."""
import logging
import os
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError

CPU = mx.cpu()
RTOL = ATOL = 1e-5          # small float32 graphs, two frameworks
STEP_L2 = 0.05              # the thumbnail's step, from one state


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's arrays (the iterators' batches among them) on the CPU."""
    with CPU:
        yield


def _toy_problem(n=512, d=16, k=3, seed=0):
    """tests/test_module.py:10-15."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    W = rng.randn(d, k).astype(np.float32)
    Y = np.argmax(X @ W, axis=1).astype(np.float32)
    return X, Y


def _mlp_sym(sym, hidden=32, classes=3):
    """tests/test_module.py:18-24."""
    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=classes, name="fc2")
    return sym.SoftmaxOutput(net, sym.var("softmax_label"), name="softmax")


def _iters(X, Y, batch, **kw):
    jit = jmx.io.NDArrayIter(X, Y, batch_size=batch,
                             label_name="softmax_label", **kw)
    it = mx.io.NDArrayIter(X, Y, batch_size=batch,
                           label_name="softmax_label", **kw)
    return jit, it


def _np_params(params):
    return {k: v.asnumpy() for k, v in params.items()}


def _port_params(params):
    return {k: mx.nd.array(v, ctx=CPU) for k, v in params.items()}


def _pair(X, Y, batch, for_training=True, **mod_kw):
    """A JAX Module with Uniform(0.1) weights and a port Module bound on
    the CPU with the same weights."""
    jit, it = _iters(X, Y, batch)
    jmod = jmx.mod.Module(_mlp_sym(jmx.sym), **mod_kw)
    jmod.bind(jit.provide_data, jit.provide_label, for_training=for_training)
    jmx.random.seed(0)
    jmod.init_params(jmx.init.Uniform(0.1))
    mod = mx.mod.Module(_mlp_sym(mx.sym), context=CPU, **mod_kw)
    mod.bind(it.provide_data, it.provide_label, for_training=for_training)
    arg, aux = jmod.get_params()
    mod.init_params(arg_params=_port_params(_np_params(arg)),
                    aux_params=_port_params(_np_params(aux)))
    return jmod, mod, jit, it


def test_toy_mlp_converges_in_both_packages():
    """tests/test_module.py:27-36 in both packages."""
    X, Y = _toy_problem()
    params = (("learning_rate", 0.5), ("rescale_grad", 1.0 / 64))
    jit, it = _iters(X, Y, 64, shuffle=True)
    jmod = jmx.mod.Module(_mlp_sym(jmx.sym))
    jmod.fit(jit, num_epoch=8, optimizer_params=params)
    mod = mx.mod.Module(_mlp_sym(mx.sym), context=CPU)
    mx.random.seed(0)
    mod.fit(it, num_epoch=8, optimizer_params=params)
    for m, data in ((jmod, jit), (mod, it)):
        acc = dict(m.score(data, "acc"))["accuracy"]
        assert acc > 0.9, acc


def test_predict_score_and_a_step_match_jax_from_the_same_weights():
    X, Y = _toy_problem(n=128)
    jmod, mod, jit, it = _pair(X, Y, 32)
    np.testing.assert_allclose(mod.predict(it).asnumpy(),
                               jmod.predict(jit).asnumpy(), rtol=RTOL,
                               atol=ATOL)
    assert mod.predict(it, merge_batches=False)[0][0].shape == (32, 3)
    np.testing.assert_allclose(dict(mod.score(it, "acc"))["accuracy"],
                               dict(jmod.score(jit, "acc"))["accuracy"])
    params = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
              "rescale_grad": 1.0 / 32}
    jmod.init_optimizer(kvstore=None, optimizer="sgd",
                        optimizer_params=params)
    mod.init_optimizer(kvstore=None, optimizer="sgd",
                       optimizer_params=params)
    # the port names the parameters (MXNet 1.x): no weight decay on the
    # biases; give the JAX optimizer the same table
    jmod._optimizer.idx2name = dict(enumerate(jmod._param_names))
    jmod._optimizer.set_wd_mult({})
    for batch, jbatch in zip(it, jit):
        mod.forward_backward(batch)
        jmod.forward_backward(jbatch)
        mod.update()
        jmod.update()
    arg, _ = mod.get_params()
    jarg, _ = jmod.get_params()
    for name in arg:
        np.testing.assert_allclose(arg[name].asnumpy(),
                                   jarg[name].asnumpy(), rtol=1e-4,
                                   atol=1e-5)


def test_fixed_parameters_stay_and_the_others_step_as_jax():
    X, Y = _toy_problem(n=64)
    jmod, mod, jit, it = _pair(X, Y, 32, fixed_param_names=["fc1_weight"])
    params = (("learning_rate", 0.5), ("rescale_grad", 1.0 / 32))
    jmod.init_optimizer(optimizer_params=params)
    mod.init_optimizer(optimizer_params=params)
    w0 = mod._exec.arg_dict["fc1_weight"].asnumpy()
    b0 = mod._exec.arg_dict["fc2_bias"].asnumpy()
    assert "fc1_weight" not in mod._exec.grad_dict
    mod.forward_backward(next(iter(it)))
    mod.update()
    jmod.forward_backward(next(iter(jit)))
    jmod.update()
    np.testing.assert_array_equal(mod._exec.arg_dict["fc1_weight"].asnumpy(),
                                  w0)
    assert not np.array_equal(mod._exec.arg_dict["fc2_bias"].asnumpy(), b0)
    for name in ("fc1_bias", "fc2_weight", "fc2_bias"):
        np.testing.assert_allclose(
            mod._exec.arg_dict[name].asnumpy(),
            jmod._exec.arg_dict[name].asnumpy(), rtol=RTOL, atol=ATOL)


def test_input_gradients_match_jax():
    X, Y = _toy_problem(n=32)
    jit, it = _iters(X, Y, 16)
    jmod = jmx.mod.Module(_mlp_sym(jmx.sym))
    jmod.bind(jit.provide_data, jit.provide_label, inputs_need_grad=True)
    jmx.random.seed(0)
    jmod.init_params(jmx.init.Uniform(0.1))
    mod = mx.mod.Module(_mlp_sym(mx.sym), context=CPU)
    mod.bind(it.provide_data, it.provide_label, inputs_need_grad=True)
    arg, aux = jmod.get_params()
    mod.set_params(_port_params(_np_params(arg)), {})
    jmod.forward_backward(next(iter(jit)))
    mod.forward_backward(next(iter(it)))
    (g,), (jg,) = mod.get_input_grads(), jmod.get_input_grads()
    assert g.shape == (16, 16)
    np.testing.assert_allclose(g.asnumpy(), jg.asnumpy(), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(MXNetError, match="inputs_need_grad"):
        mx.mod.Module(_mlp_sym(mx.sym), context=CPU).get_input_grads()


def test_checkpoints_load_in_both_packages(tmp_path):
    """The port's ``save_checkpoint`` read by the JAX ``Module.load`` and
    the JAX package's read by the port's, predicting the same; the
    port's optimizer states resume its next update bit for bit; the
    ``do_checkpoint`` callback of ``fit`` writes the epoch's files."""
    X, Y = _toy_problem(n=128)
    jit, it = _iters(X, Y, 32)
    mod = mx.mod.Module(_mlp_sym(mx.sym), context=CPU)
    mx.random.seed(0)
    prefix = str(tmp_path / "port")
    mod.fit(it, num_epoch=2, optimizer_params=(("learning_rate", 0.1),
                                              ("momentum", 0.9)),
            kvstore=mx.kv.create("local"),
            epoch_end_callback=mx.callback.do_checkpoint(prefix))
    assert os.path.exists(f"{prefix}-0002.params")
    mod.save_checkpoint(prefix, 7, save_optimizer_states=True)
    jmod = jmx.mod.Module.load(prefix, 7)
    jmod.bind(jit.provide_data, jit.provide_label, for_training=False)
    jmod.init_params_from_preload()
    want = mod.predict(it).asnumpy()
    np.testing.assert_allclose(jmod.predict(jit).asnumpy(), want,
                               rtol=RTOL, atol=ATOL)

    back = mx.mod.Module.load(prefix, 7, load_optimizer_states=True,
                              context=CPU)
    back.bind(it.provide_data, it.provide_label)
    np.testing.assert_array_equal(back.predict(it).asnumpy(), want)
    back.init_optimizer(kvstore=mx.kv.create("local"),
                        optimizer_params=(("learning_rate", 0.1),
                                          ("momentum", 0.9)))
    it.reset()
    batch = next(iter(it))
    for m in (mod, back):
        m.forward_backward(batch)
        m.update()
    for name, a in mod.get_params()[0].items():
        np.testing.assert_array_equal(back.get_params()[0][name].asnumpy(),
                                      a.asnumpy())

    jprefix = str(tmp_path / "jax")
    jmod.save_checkpoint(jprefix, 3)
    mine = mx.mod.Module.load(jprefix, 3, context=CPU)
    mine.bind(it.provide_data, it.provide_label, for_training=False)
    np.testing.assert_allclose(mine.predict(it).asnumpy(), want, rtol=RTOL,
                               atol=ATOL)


def _thumbnail_symbols():
    """The JAX thumbnail resnet18_v1 exported with a SoftmaxOutput head,
    and the same graph read by the port."""
    import tempfile

    jnet = jvision.get_model("resnet18_v1", classes=10, thumbnail=True,
                             prefix="thumb_")
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.zeros((1, 3, 32, 32)))
    with tempfile.TemporaryDirectory() as d:
        jnet.export(os.path.join(d, "net"), 0)
        jsym, _, _ = jmx.model.load_checkpoint(os.path.join(d, "net"), 0)
    jsym = jmx.sym.SoftmaxOutput(jsym, jmx.sym.var("softmax_label"),
                                 name="softmax")
    return jsym, mx.sym.load_json(jsym.tojson())


def _host(a):
    return np.array(a.asnumpy() if hasattr(a, "asnumpy") else a,
                    dtype=np.float32)


def test_thumbnail_resnet18_steps_match_jax_module():
    jsym, sym = _thumbnail_symbols()
    assert sym.list_arguments() == jsym.list_arguments()
    shapes = ([("data", (8, 3, 32, 32))], [("softmax_label", (8,))])
    jmod = jmx.mod.Module(jsym)
    jmod.bind(*shapes)
    jmx.random.seed(0)
    jmod.init_params(jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                     magnitude=2))
    mod = mx.mod.Module(sym, context=CPU)
    mod.bind(*shapes)
    arg, aux = jmod.get_params()
    mod.init_params(arg_params=_port_params(_np_params(arg)),
                    aux_params=_port_params(_np_params(aux)))
    assert len(mod._param_names) == 60 and len(mod._aux_names) == 38
    hyper = dict(learning_rate=0.05, momentum=0.9, wd=1e-4,
                 rescale_grad=1.0 / 8)
    jmod.init_optimizer(kvstore=None,
                        optimizer=jmx.optimizer.SGD(**hyper))
    mod.init_optimizer(kvstore=None, optimizer=mx.optimizer.SGD(**hyper))
    rs = np.random.RandomState(0)
    for step in range(2):
        x = rs.rand(8, 3, 32, 32).astype(np.float32)
        y = rs.randint(0, 10, 8).astype(np.float32)
        # the port's state set to the JAX Module's
        for name in mod._param_names:
            mod._exec.arg_dict[name]._data.copy_(torch.from_numpy(
                _host(jmod._exec.arg_dict[name])))
        for name in mod._aux_names:
            mod._exec.aux_dict[name]._data.copy_(torch.from_numpy(
                _host(jmod._exec.aux_dict[name])))
        for idx, st in jmod._updater.states.items():
            mod._updater.states[idx]._data.copy_(torch.from_numpy(_host(st)))
        for m, nd, ctx in ((jmod, jmx.nd, None), (mod, mx.nd, CPU)):
            kw = {"ctx": ctx} if ctx else {}
            m.forward_backward((jmx if m is jmod else mx).io.DataBatch(
                data=[nd.array(x, **kw)], label=[nd.array(y, **kw)]))
            m.update()
        np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(),
                                   _host(jmod.get_outputs()[0]), rtol=RTOL,
                                   atol=ATOL)
        for name in mod._aux_names:
            ref = _host(jmod._exec.aux_dict[name])
            np.testing.assert_allclose(
                mod._exec.aux_dict[name].asnumpy(), ref, rtol=RTOL,
                atol=RTOL * max(float(np.abs(ref).max()), 1.0))
        for idx, name in enumerate(mod._param_names):
            jm = _host(jmod._updater.states[idx])
            norm = max(float(np.linalg.norm(jm)), 1e-30)
            for got, want in ((mod._exec.arg_dict[name].asnumpy(),
                               _host(jmod._exec.arg_dict[name])),
                              (mod._updater.states[idx].asnumpy(), jm)):
                err = float(np.linalg.norm(got - want)) / norm
                assert err <= STEP_L2, (step, name, err)


def test_c8_init_optimizer_follows_mxnet_not_the_jax_module():
    """Fault C8: with an optimizer name and no ``rescale_grad``, MXNet
    1.x's ``Module.init_optimizer`` sets ``rescale_grad = 1 /
    batch_size`` and names the parameters (no weight decay on biases
    and betas); the JAX Module keeps 1.0 and decays every parameter.
    Fault C9: MXNet 1.x's ``init_params`` initializes the auxiliary
    states (the running variance to ones); the JAX Module leaves the
    zeros ``simple_bind`` made."""
    def build(sym):
        net = sym.Convolution(sym.var("data"), num_filter=4, kernel=(3, 3),
                              name="c")
        net = sym.BatchNorm(net, name="bn")
        net = sym.FullyConnected(net, num_hidden=3, name="fc")
        return sym.SoftmaxOutput(net, sym.var("softmax_label"),
                                 name="softmax")

    shapes = ([("data", (8, 2, 5, 5))], [("softmax_label", (8,))])
    params = {"learning_rate": 0.1, "wd": 1e-4}
    jmod = jmx.mod.Module(build(jmx.sym))
    jmod.bind(*shapes)
    jmod.init_params(jmx.init.Xavier())
    jmod.init_optimizer(optimizer="sgd", optimizer_params=params)
    mod = mx.mod.Module(build(mx.sym), context=CPU)
    mod.bind(*shapes)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=params)
    names = mod._param_names
    assert names == jmod._param_names == ["c_weight", "c_bias", "bn_gamma",
                                          "bn_beta", "fc_weight", "fc_bias"]
    assert jmod._optimizer.rescale_grad == 1.0
    assert mod._optimizer.rescale_grad == 1.0 / 8
    assert jmod._optimizer._get_wds(list(range(6))) == [1e-4] * 6
    assert mod._optimizer._get_wds(names) == [1e-4, 0.0, 1e-4, 0.0, 1e-4,
                                              0.0]
    assert float(jmod._exec.aux_dict["bn_moving_var"].asnumpy().max()) == 0
    np.testing.assert_array_equal(
        mod._exec.aux_dict["bn_moving_var"].asnumpy(), np.ones(4))
    given = mx.mod.Module(build(mx.sym), context=CPU)
    given.bind(*shapes)
    given.init_params(mx.init.Xavier())
    given.init_optimizer(optimizer="sgd",
                         optimizer_params=dict(params, rescale_grad=0.5))
    assert given._optimizer.rescale_grad == 0.5


def test_update_is_one_k1_launch_and_equals_key_by_key(monkeypatch):
    """``Module.update`` pushes every gradient in one call and pulls every
    weight in one: K1's plain version runs once over all of them (on the
    card, one launch), and the weights equal those of the JAX Module's
    route, a push and a pull per key."""
    X, Y = _toy_problem(n=32)
    jit, it = _iters(X, Y, 32)
    entry = kernels.entry("opt_sgd")
    plain, calls = entry.plain, []

    def counting(ws, *a, **k):
        calls.append(len(ws))
        return plain(ws, *a, **k)

    monkeypatch.setattr(entry, "plain", counting)
    mods = []
    for _ in range(2):
        mod = mx.mod.Module(_mlp_sym(mx.sym), context=CPU)
        mod.bind(it.provide_data, it.provide_label)
        mx.random.seed(3)
        mod.init_params(mx.init.Xavier())
        mod.init_optimizer(kvstore=mx.kv.create("local"), optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9, "wd": 1e-3})
        mods.append(mod)
    batch = next(iter(it))
    for step in range(2):
        calls.clear()
        mods[0].forward_backward(batch)
        mods[0].update()
        assert calls == [4]
        mods[1].forward_backward(batch)
        kv, ex = mods[1]._kvstore, mods[1]._exec
        for name in mods[1]._param_names:
            kv.push(name, ex.grad_dict[name])
            kv.pull(name, out=ex.arg_dict[name])
        assert calls == [4, 1, 1, 1, 1]
        for name in mods[0]._param_names:
            np.testing.assert_array_equal(
                mods[0]._exec.arg_dict[name].asnumpy(),
                ex.arg_dict[name].asnumpy())


def test_a_string_kvstore_on_one_card_updates_in_place():
    """MXNet 1.x's ``_create_kvstore``: a type name with one context and
    no ``dist`` makes no store; a store object is used, with the
    optimizer on it."""
    X, Y = _toy_problem(n=32)
    _, it = _iters(X, Y, 32)
    for kv, on_store in (("local", False), (None, False),
                         (mx.kv.create("local"), True)):
        mod = mx.mod.Module(_mlp_sym(mx.sym), context=CPU)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params()
        mod.init_optimizer(kvstore=kv)
        assert mod._update_on_kvstore is on_store
        assert (mod._kvstore is not None) is on_store
        it.reset()
        mod.forward_backward(next(iter(it)))
        mod.update()


def test_monitor_reports_the_jax_names_and_statistics():
    X, Y = _toy_problem(n=32)
    jmod, mod, jit, it = _pair(X, Y, 32)
    got = {}
    for m, pkg, data in ((jmod, jmx, jit), (mod, mx, it)):
        mon = pkg.monitor.Monitor(1, pattern="fc.*")
        m.install_monitor(mon)
        mon.tic()
        m.forward_backward(next(iter(data)))
        got[pkg.__name__] = mon.toc()
    mine, theirs = got["mxnet_tpu_torch"], got["mxnet_tpu"]
    assert [k for _, k, _ in mine] == [k for _, k, _ in theirs] == [
        "fc1_weight", "fc1_weight_grad", "fc1_bias", "fc1_bias_grad",
        "fc2_weight", "fc2_weight_grad", "fc2_bias", "fc2_bias_grad"]
    np.testing.assert_allclose([float(v) for _, _, v in mine],
                               [float(v) for _, _, v in theirs], rtol=1e-4)


def test_fit_logs_speedometer_and_feedforward_matches_jax(caplog):
    X, Y = _toy_problem(n=128)
    _, it = _iters(X, Y, 32)
    mod = mx.mod.Module(_mlp_sym(mx.sym), context=CPU)
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1},
                batch_end_callback=mx.callback.Speedometer(32, 2))
    msgs = [r.getMessage() for r in caplog.records]
    assert any(re.match(r"Epoch\[0\] Batch \[0-2\]\tSpeed: [0-9.]+ "
                        r"samples/sec\taccuracy=[0-9.]+$", m) for m in msgs)
    assert any(m.startswith("Epoch[0] Train-accuracy=") for m in msgs)
    # FeedForward from one set of weights predicts as the JAX one
    arg, aux = mod.get_params()
    ff = mx.model.FeedForward(_mlp_sym(mx.sym), ctx=CPU, arg_params=arg,
                              aux_params=aux, numpy_batch_size=32)
    jff = jmx.model.FeedForward(
        _mlp_sym(jmx.sym), arg_params={k: jmx.nd.array(v.asnumpy())
                                       for k, v in arg.items()},
        aux_params={}, numpy_batch_size=32)
    np.testing.assert_allclose(ff.predict(X), jff.predict(X), rtol=RTOL,
                               atol=ATOL)
    X, Y = _toy_problem()
    mx.random.seed(0)
    trained = mx.model.FeedForward.create(
        _mlp_sym(mx.sym), X, Y, ctx=CPU, num_epoch=8, numpy_batch_size=64,
        learning_rate=0.5)
    assert trained.score(mx.io.NDArrayIter(X, Y, 64)) > 0.9
    assert trained.predict(X).shape == (512, 3)


def test_a_module_needs_a_card_or_the_cpu_and_one_context():
    sym = _mlp_sym(mx.sym)
    with pytest.raises(MXNetError, match="A4"):
        mx.mod.Module(sym, context=[mx.cpu(0), mx.cpu(1)])
    with pytest.raises(MXNetError, match="not arguments"):
        mx.mod.Module(sym, context=CPU, data_names=("x",))
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA card"):
            mx.mod.Module(sym, context=mx.gpu(0))


@pytest.mark.parametrize("kwargs, match", [
    ({"compression_params": {"type": "2bit"}}, "A4"),
    ({"work_load_list": [1, 1]}, "A4"),
    ({"group2ctxs": {"dev1": CPU}}, "A5"),
], ids=["compression_params", "work_load_list", "group2ctxs"])
def test_a_module_refuses_what_it_cannot_honour(kwargs, match):
    sym = _mlp_sym(mx.sym)
    with pytest.raises(MXNetError, match=match):
        mx.mod.Module(sym, context=CPU, **kwargs)
    mx.mod.Module(sym, context=CPU, work_load_list=[1])   # one context
    if "work_load_list" in kwargs:
        X, Y = _toy_problem(n=64)
        with pytest.raises(MXNetError, match=match):
            mx.model.FeedForward(sym, ctx=CPU).fit(X, Y, **kwargs)


@pytest.mark.parametrize("nkeys", [1, 3])
def test_a_pull_is_one_multi_tensor_copy_into_each_targets_dtype(
        monkeypatch, nkeys):
    """``KVStore.pull`` of one key or of several is one
    ``torch._foreach_copy_`` over every target, each keeping its dtype."""
    kv = mx.kv.create("local")
    keys = [f"k{i}" for i in range(nkeys)]
    kv.init(keys, [mx.nd.array(np.full((2, 3), i + 0.5, np.float32),
                               ctx=CPU) for i in range(nkeys)])
    outs = [[mx.nd.zeros((2, 3), ctx=CPU),
             mx.nd.zeros((2, 3), ctx=CPU, dtype="float64")] for _ in keys]
    calls, real = [], torch._foreach_copy_
    monkeypatch.setattr(torch, "_foreach_copy_",
                        lambda dst, src: (calls.append(len(dst)),
                                          real(dst, src)))
    if nkeys == 1:
        kv.pull(keys[0], out=outs[0])
    else:
        kv.pull(keys, out=outs)
    assert calls == [2 * nkeys]
    for i, (f32, f64) in enumerate(outs):
        assert (f32.dtype, f64.dtype) == (torch.float32, torch.float64)
        np.testing.assert_array_equal(f64.asnumpy(), np.full((2, 3), i + 0.5))
        np.testing.assert_array_equal(f32.asnumpy(), f64.asnumpy())
    with pytest.raises(ValueError, match="shape"):
        kv.pull(keys[0], out=mx.nd.zeros((3, 2), ctx=CPU))
