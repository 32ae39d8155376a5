"""``ShardedTrainer`` with every optimizer rule of
``parallel/opt_rules.py`` against the JAX ``ShardedTrainer`` on the CPU,
and the fit path with "nag" through ``Module`` against the JAX ``Module``.

A two-layer tanh classifier (no ReLU kinks, so both packages' gradients
agree to float32 rounding) takes 3 steps from the same weights in both
packages. Each step's loss is held to rtol 1e-5 and every parameter after
the last step to ``atol = 1e-3 * lr`` (a thousandth of one step of a
unit gradient; largest error met: 2.4e-7 absolute, Nadam). SGLD's noise
comes from different generators, so its step less the noise the port
drew is held to the JAX "sgd" step at half the rate. The rules' master route
(float16 weights under ``multi_precision``) is held the same way against
the JAX rule run on the float32 masters.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.parallel import DeviceMesh as JaxMesh
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu_torch.convert import export_params, load_jax_params
from mxnet_tpu_torch.optimizer import optimizer as popt
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer
from mxnet_tpu_torch.parallel.opt_rules import RULES

CPU = mx.cpu()
BATCH, IN, HID, OUT, STEPS = 8, 6, 16, 4, 3
PARAMS = {
    "nag": dict(learning_rate=0.05, momentum=0.9, wd=1e-3),
    "signum": dict(learning_rate=0.01, momentum=0.9, wd=1e-3, wd_lh=1e-3),
    "ftml": dict(learning_rate=0.01, wd=1e-3),
    "lars": dict(learning_rate=0.5, momentum=0.9, wd=1e-3, eta=0.1),
    "lbsgd": dict(learning_rate=0.05, momentum=0.9, wd=1e-3,
                  batch_scale=2, warmup_epochs=1, updates_per_epoch=4),
    "lamb": dict(learning_rate=0.01, wd=1e-3),
    "dcasgd": dict(learning_rate=0.05, momentum=0.9, wd=1e-3),
    "adagrad": dict(learning_rate=0.05, wd=1e-3),
    "rmsprop": dict(learning_rate=0.01, wd=1e-3, centered=True),
    "adadelta": dict(wd=1e-3),
    "ftrl": dict(learning_rate=0.1, wd=1e-3),
    "adamax": dict(learning_rate=0.01, wd=1e-3),
    "nadam": dict(learning_rate=0.01, wd=1e-3),
    "test": dict(learning_rate=0.05),
    "sgld": dict(learning_rate=0.01, wd=1e-3),
}


def _net(pkg):
    net = pkg.gluon.nn.HybridSequential(prefix="m_")
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(HID, activation="tanh", in_units=IN),
                pkg.gluon.nn.Dense(OUT, in_units=HID))
    return net


def _weights():
    rs = np.random.RandomState(0)
    return {"0.weight": rs.randn(HID, IN) * 0.5,
            "0.bias": rs.randn(HID) * 0.1,
            "1.weight": rs.randn(OUT, HID) * 0.5,
            "1.bias": rs.randn(OUT) * 0.1}


def _batches():
    rs = np.random.RandomState(1)
    return [(rs.randn(BATCH, IN).astype(np.float32),
             rs.randint(0, OUT, BATCH).astype(np.float32))
            for _ in range(STEPS)]


def _pair(name, params, clip=0.5):
    weights = {k: v.astype(np.float32) for k, v in _weights().items()}
    params = dict(params, rescale_grad=1.0, clip_gradient=clip)
    with mx.name.NameManager():
        net = _net(mx)
    net.initialize(ctx=CPU)
    load_jax_params(net, weights)
    st = ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), name,
                        dict(params), mesh=DeviceMesh({"dp": 1},
                                                      devices=[CPU]))
    jnet = _net(jmx)
    jnet.initialize()
    for n, p in jnet._collect_params_with_structure().items():
        p.set_data(jmx.nd.array(weights[n]))
    jst = JaxTrainer(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), name,
                     dict(params), mesh=JaxMesh({"dp": 1}))
    return net, st, jnet, jst


@pytest.mark.parametrize("name", sorted(set(PARAMS) - {"sgld"}))
def test_trainer_rule_matches_the_jax_sharded_trainer(name):
    net, st, jnet, jst = _pair(name, PARAMS[name])
    for x, y in _batches():
        got = st.step(mx.nd.array(x, ctx=CPU),
                      mx.nd.array(y, ctx=CPU)).asscalar()
        want = jst.step(jmx.nd.array(x), jmx.nd.array(y)).asscalar()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    got = export_params(net)
    lr = PARAMS[name].get("learning_rate", 1.0)
    for n, p in jnet._collect_params_with_structure().items():
        np.testing.assert_allclose(got[n], p.data().asnumpy(), rtol=0,
                                   atol=1e-3 * lr, err_msg=f"{name} {n}")
    assert st.skipped_steps == 0 and st._t == STEPS


def test_sgld_rule_is_the_jax_sgd_half_step_plus_the_drawn_noise():
    """One SGLD step: the port's weights minus the noise it drew (redrawn
    from the generator state before the step) are ``w - lr / 2 * (clip(g
    * rescale) + wd * w)``, which is the JAX trainer's plain "sgd" step at
    half the rate (the JAX SGLD rule's noise comes from threefry keys the
    port cannot draw); the noise of the weight matrices has variance lr."""
    from mxnet_tpu_torch import random as prandom

    lr = PARAMS["sgld"]["learning_rate"]
    net, st, _, _ = _pair("sgld", PARAMS["sgld"])
    _, _, jnet, jst = _pair("sgd", dict(PARAMS["sgld"],
                                        learning_rate=lr / 2))
    x, y = _batches()[0]
    mx.random.seed(3)
    state = prandom.get_state(torch.device("cpu")).clone()
    st.step(mx.nd.array(x, ctx=CPU), mx.nd.array(y, ctx=CPU))
    prandom.set_state(3, state, torch.device("cpu"))
    gen = prandom.generator(torch.device("cpu"))
    noise = [torch.randn(h.shape, generator=gen).numpy() * np.sqrt(
        np.float32(lr)) for h in st._train_handles]
    jst.step(jmx.nd.array(x), jmx.nd.array(y))
    got = export_params(net)
    for (n, p), nz in zip(jnet._collect_params_with_structure().items(),
                          noise):
        np.testing.assert_allclose(got[n] - nz, p.data().asnumpy(), rtol=0,
                                   atol=1e-6, err_msg=n)
    drawn = np.concatenate([nz.ravel() for nz in noise if nz.ndim == 2])
    assert abs(drawn.var() / lr - 1) < 0.2


@pytest.mark.parametrize("name", ["nag", "lamb", "nadam", "rmsprop"])
def test_master_route_matches_the_jax_rule_on_float32_masters(name):
    """float16 weights with ``multi_precision``: one step's masters
    against the JAX trainer's float32 masters (same float16 weights,
    gradients of the float16 forward differ in rounding), and each weight
    its master rounded."""
    net, st, jnet, jst = _pair(name, dict(PARAMS[name],
                                          multi_precision=True))
    net.cast("float16")
    jnet.cast("float16")
    st = ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), name,
                        dict(PARAMS[name], multi_precision=True,
                             clip_gradient=0.5),
                        mesh=DeviceMesh({"dp": 1}, devices=[CPU]))
    jst = JaxTrainer(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), name,
                     dict(PARAMS[name], multi_precision=True,
                          clip_gradient=0.5), mesh=JaxMesh({"dp": 1}))
    assert st.route_counts == {"float32": 0, "master": 0, "half": 0}
    for x, y in _batches()[:1]:
        st.step(mx.nd.array(x, ctx=CPU).astype("float16"),
                mx.nd.array(y, ctx=CPU))
        jst.step(jmx.nd.array(x).astype("float16"), jmx.nd.array(y))
    assert st.route_counts["master"] == 4
    lr = PARAMS[name]["learning_rate"]
    for i, h in enumerate(st._train_handles):
        master = st._opt_state[i][0]
        jmaster = np.asarray(jst._opt_raws[i][0])
        # the float16 forward and backward round the gradients
        # differently in the two packages; RMSProp's first step scales
        # every gradient to about 3.2 lr in magnitude, so a gradient near
        # zero moves by up to 2.04e-2 lr (met); 5e-2 lr holds all four
        np.testing.assert_allclose(master.numpy(), jmaster, rtol=0,
                                   atol=5e-2 * lr)
        np.testing.assert_array_equal(h._data.numpy(),
                                      master.to(torch.float16).numpy())


def test_every_rule_of_the_jax_module_is_registered_and_trains():
    from mxnet_tpu.parallel.opt_rules import RULES as JRULES

    assert sorted(RULES) == sorted(JRULES)
    for name in RULES:
        if name == "signsgd":
            continue
        net, st, _, _ = _pair(name, PARAMS.get(name, {}))
        x, y = _batches()[0]
        loss = st.step(mx.nd.array(x, ctx=CPU), mx.nd.array(y, ctx=CPU))
        assert np.isfinite(loss.asnumpy()).all()


def test_nadam_schedule_and_lamb_step_stay_device_scalars():
    """Nadam's schedule rides in each parameter's state as a float32
    0-dim tensor that the step advances; the step count reaches every
    rule as the trainer's device scalar."""
    net, st, _, _ = _pair("nadam", PARAMS["nadam"])
    assert all(s[2].shape == () and s[2].dtype == torch.float32
               for s in st._opt_state)
    for x, y in _batches():
        st.step(mx.nd.array(x, ctx=CPU), mx.nd.array(y, ctx=CPU))
    opt = st._opt
    sched = 1.0
    for t in range(1, STEPS + 1):
        sched *= opt.beta1 * (1 - 0.5 * 0.96 ** (t * opt.schedule_decay))
    for s in st._opt_state:
        np.testing.assert_allclose(float(s[2]), sched, rtol=1e-6)


@pytest.fixture
def _on_cpu():
    with mx.cpu():
        yield


def test_module_fit_with_nag_matches_the_jax_module(_on_cpu):
    """The fit path's optimizer with ``--optimizer nag``: three batches
    of ``Module`` forward/backward/update over a small symbol, in both
    packages from the same weights (``rescale_grad`` given to both, fault
    C8)."""
    def symbol(pkg):
        data = pkg.sym.var("data")
        fc1 = pkg.sym.FullyConnected(data, num_hidden=HID, name="fc1")
        act = pkg.sym.Activation(fc1, act_type="tanh", name="act")
        fc2 = pkg.sym.FullyConnected(act, num_hidden=OUT, name="fc2")
        return pkg.sym.SoftmaxOutput(fc2, name="softmax")

    rs = np.random.RandomState(0)
    args = {"fc1_weight": rs.randn(HID, IN) * 0.5, "fc1_bias": rs.randn(HID),
            "fc2_weight": rs.randn(OUT, HID) * 0.5, "fc2_bias": rs.randn(OUT)}
    args = {k: v.astype(np.float32) for k, v in args.items()}
    # no weight decay: the JAX Module decays biases too (fault C8)
    opt_params = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.0,
                  "rescale_grad": 1.0 / BATCH}
    mods = []
    for pkg in (mx, jmx):
        mod = pkg.mod.Module(symbol(pkg), context=pkg.cpu())
        mod.bind(data_shapes=[("data", (BATCH, IN))],
                 label_shapes=[("softmax_label", (BATCH,))])
        mod.init_params(arg_params={k: pkg.nd.array(v)
                                    for k, v in args.items()})
        mod.init_optimizer(kvstore="local", optimizer="nag",
                           optimizer_params=dict(opt_params))
        mods.append(mod)
    for x, y in _batches():
        for pkg, mod in zip((mx, jmx), mods):
            batch = pkg.io.DataBatch([pkg.nd.array(x)], [pkg.nd.array(y)])
            mod.forward_backward(batch)
            mod.update()
    got, _ = mods[0].get_params()
    want, _ = mods[1].get_params()
    for n in args:
        np.testing.assert_allclose(got[n].asnumpy(), want[n].asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    assert isinstance(mods[0]._optimizer, popt.NAG)
