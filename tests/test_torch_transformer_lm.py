"""``examples/gluon/transformer_lm.py``'s causal LM at the example's
defaults, trained by ``ShardedTrainer`` with ``"adam"`` on the CPU in
both packages from the same weights (carried by
``convert.load_jax_params``): plain, with ``accum_steps=2`` and with
``remat=True``, each against the JAX trainer's same setting, under the
tolerances ``tests/test_torch_train.py`` states (each step's loss rtol
1e-5; every weight after three steps within 1e-2 * lr, the attention key
biases within 1 * lr: their true gradient is zero and Adam turns the
rounding noise there into steps of about lr). Then, in the port alone:
an accumulated step against the unaccumulated step on the same batch
(loss and each gradient within 1e-5), BatchNorm's statistics carried
from microbatch to microbatch as the JAX scan carries them, and
``remat=True`` bit for bit equal to ``remat=False`` (with Dropout too:
the recomputed forward draws the same masks)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import LM_DEFAULTS, build_lm, lm_corpus, lm_windows
from mxnet_tpu.parallel import DeviceMesh as JaxMesh
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu_torch.convert import export_params, load_jax_params
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

CFG = LM_DEFAULTS
STEPS = 3
CPU = mx.cpu()
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def batches():
    ids = lm_corpus(CFG["vocab"], CFG["corpus_tokens"])
    windows, labels = lm_windows(ids, CFG["seq_len"])
    rng = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        sel = rng.randint(0, len(windows), CFG["batch"])
        out.append((windows[sel].astype(np.float32),
                    labels[sel].astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def weights(batches):
    """The JAX LM's Xavier weights, by structural name."""
    jmx.random.seed(0)
    net, _, _ = build_lm(jmx, CFG)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(batches[0][0]), jmx.nd.arange(CFG["seq_len"]))
    return {n: p.data().asnumpy()
            for n, p in net._collect_params_with_structure().items()}


def _port(weights, dropout=0.0, **kw):
    with CPU:
        net, adapter, loss = build_lm(mx, CFG, dropout=dropout, ctx=CPU)
        net.initialize(mx.init.Xavier(), ctx=CPU)
        load_jax_params(net, weights)
        st = ShardedTrainer(adapter, loss, "adam",
                            {"learning_rate": CFG["lr"]},
                            mesh=DeviceMesh({"dp": 1}, devices=[CPU]), **kw)
    return net, st


def _jax(weights, **kw):
    net, adapter, loss = build_lm(jmx, CFG)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(np.zeros((2, CFG["seq_len"]), np.float32)),
        jmx.nd.arange(CFG["seq_len"]))
    for name, p in net._collect_params_with_structure().items():
        p.set_data(jmx.nd.array(weights[name]))
    st = JaxTrainer(adapter, loss, "adam", {"learning_rate": CFG["lr"]},
                    mesh=JaxMesh({"dp": 1}), **kw)
    return net, st


def _step(st, x, y):
    with CPU:
        return float(st.step(mx.nd.array(x), mx.nd.array(y)).asscalar())


@pytest.mark.parametrize("kw", [{}, {"accum_steps": 2}, {"remat": True}],
                         ids=["plain", "accum_steps2", "remat"])
def test_lm_steps_match_the_jax_trainer(batches, weights, kw):
    net, st = _port(weights, **kw)
    jnet, jst = _jax(weights, **kw)
    losses = []
    for x, y in batches:
        got = _step(st, x, y)
        want = float(jst.step(jmx.nd.array(x), jmx.nd.array(y)).asscalar())
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        losses.append(got)
    assert st.skipped_steps == 0 and losses[-1] < losses[0]
    got = export_params(net)
    want = {n: p.data().asnumpy()
            for n, p in jnet._collect_params_with_structure().items()}
    assert set(got) == set(want)
    lr = CFG["lr"]
    for name in want:
        noise = name.endswith("attn.key.bias")
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=(1.0 if noise else 1e-2) * lr,
                                   err_msg=name)


def _sgd_update(weights, x, y, accum):
    """One SGD step (lr 1, no momentum or decay) from ``weights``:
    ``(loss, {name: weight - new weight})``, the gradient."""
    with CPU:
        net, adapter, loss = build_lm(mx, CFG, ctx=CPU)
        net.initialize(mx.init.Xavier(), ctx=CPU)
        load_jax_params(net, weights)
        st = ShardedTrainer(adapter, loss, "sgd", {"learning_rate": 1.0},
                            mesh=DeviceMesh({"dp": 1}, devices=[CPU]),
                            accum_steps=accum)
        lval = _step(st, x, y)
    after = export_params(net)
    return lval, {n: weights[n] - after[n] for n in weights}


def test_an_accumulated_step_is_the_unaccumulated_step(batches, weights):
    """``accum_steps=2`` and ``4`` against one pass over the same batch:
    the loss and each gradient within 1e-5 (relative to the tensor's
    largest entry; for the attention key biases, whose true gradient is
    zero, relative to the largest entry of any gradient): the gradients
    and the loss are each divided by k once."""
    x, y = batches[0]
    loss1, g1 = _sgd_update(weights, x, y, 1)
    top = max(float(np.abs(g).max()) for g in g1.values())
    for k in (2, 4):
        loss_k, gk = _sgd_update(weights, x, y, k)
        np.testing.assert_allclose(loss_k, loss1, rtol=1e-5)
        for name in g1:
            scale = top if name.endswith("attn.key.bias") else \
                max(float(np.abs(g1[name]).max()), 1e-30)
            np.testing.assert_allclose(gk[name] / scale, g1[name] / scale,
                                       rtol=0, atol=1e-5, err_msg=name)


def test_a_batch_accum_does_not_divide_raises_the_jax_text(weights):
    net, st = _port(weights, accum_steps=3)
    x = np.zeros((4, CFG["seq_len"]), np.float32)
    with pytest.raises(ValueError,
                       match="batch 4 not divisible by accum_steps 3"):
        _step(st, x, x)


def _bn_net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(8), pkg.gluon.nn.BatchNorm(),
            pkg.gluon.nn.Dense(3))
    return net


def test_batchnorm_statistics_carry_across_microbatches_as_in_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(8, 5).astype(np.float32) * 2 + 1
    y = rs.randn(8, 3).astype(np.float32)
    jnet = _bn_net(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    w = {n: p.data().asnumpy()
         for n, p in jnet._collect_params_with_structure().items()}
    jst = JaxTrainer(jnet, jmx.gluon.loss.L2Loss(), "sgd",
                     {"learning_rate": 0.1}, mesh=JaxMesh({"dp": 1}),
                     accum_steps=2)
    jloss = float(jst.step(jmx.nd.array(x), jmx.nd.array(y)).asscalar())
    with CPU:
        net = _bn_net(mx)
        net.initialize(mx.init.Xavier(), ctx=CPU)
        load_jax_params(net, w)
        st = ShardedTrainer(net, mx.gluon.loss.L2Loss(), "sgd",
                            {"learning_rate": 0.1},
                            mesh=DeviceMesh({"dp": 1}, devices=[CPU]),
                            accum_steps=2)
        loss = _step(st, x, y)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    got = export_params(net)
    want = {n: p.data().asnumpy()
            for n, p in jnet._collect_params_with_structure().items()}
    for name in ("1.running_mean", "1.running_var"):
        # two updates with momentum 0.9, one per microbatch
        assert not np.allclose(got[name], w[name])
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_is_bit_equal_to_no_remat(batches, weights, dropout):
    """Three Adam steps with ``remat=True`` and without, from one seed:
    the same losses and weights, bit for bit; with Dropout the
    recomputed forward draws the masks the forward drew."""
    runs = []
    for remat in (False, True):
        net, st = _port(weights, dropout=dropout, remat=remat)
        mx.random.seed(11)
        losses = [_step(st, x, y) for x, y in batches]
        runs.append((losses, export_params(net)))
    (l0, w0), (l1, w1) = runs
    assert l0 == l1
    for name in w0:
        np.testing.assert_array_equal(w1[name], w0[name], err_msg=name)
    if dropout:
        net, st = _port(weights, dropout=dropout)
        mx.random.seed(12)
        assert [_step(st, x, y) for x, y in batches] != l0
