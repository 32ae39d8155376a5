"""ResNet training through ``ShardedTrainer`` on the CPU against the JAX
package, and ``nd.random``'s samplers, which make the batch of the
ResNet-50 config (``bench.py:275-303``).

A thumbnail resnet18_v1 (10 classes, batch 8, 32x32) takes three "sgd"
steps (lr 0.05, momentum 0.9, wd 1e-4, the bench config's) in both
packages from the same weights (the JAX package's Xavier draw under
``mx.random.seed(0)``), with ``nan_guard`` on and off. Before each step
the port's weights, momenta and running statistics are set to the JAX
trainer's, so each step is compared from one state. Why: a float32
forward puts a few of the network's 4.4 M ReLU inputs within rounding of
zero, and which side they fall on differs between any two float32
implementations; each such flip moves the gradients upstream of it.
Measured at the initial weights: the port's float32 gradients against
its own float64 run, and the JAX package's against the port's float64
run, differ by up to 2.4% of a tensor's largest gradient; over six
weight draws and two steps each, one step of the two packages from one
state differed per tensor by at most 33% of the step's largest element
and by at most 1.94% of the step's L2 norm. Three unsynchronised steps
at this learning rate turn that into different trajectories.

Tolerances: the loss rtol 1e-5 and the running statistics 1e-5 of their
largest magnitude (forwards, which such flips barely move); every
weight and momentum tensor within 5% of the L2 norm of the JAX step for
that tensor (its new momentum, which SGD with momentum adds to the
weight)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.parallel import DeviceMesh as JaxMesh
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

CPU = mx.cpu()
HYPER = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
STEPS, BATCH, CLASSES = 3, 8, 10
LOSS_RTOL, AUX_TOL = 1e-5, 1e-5
UPDATE_TOL = 0.05


def _batches():
    rs = np.random.RandomState(0)
    return (rs.rand(STEPS, BATCH, 3, 32, 32).astype(np.float32),
            rs.randint(0, CLASSES, (STEPS, BATCH)).astype(np.float32))


def _pair(nan_guard):
    x, _ = _batches()
    jmx.random.seed(0)
    # one prefix for both: each package numbers unprefixed blocks with a
    # per-process counter, which other files in the same worker advance
    jnet = jvision.get_model("resnet18_v1", classes=CLASSES, thumbnail=True,
                             prefix="thumb_")
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x[0]))
    net = vision.get_model("resnet18_v1", classes=CLASSES, thumbnail=True,
                           prefix="thumb_")
    net.initialize(ctx=CPU)
    load_jax_params(net, {n: p.data().asnumpy() for n, p in
                          jnet._collect_params_with_structure().items()})
    jst = JaxTrainer(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     dict(HYPER), mesh=JaxMesh({"dp": 1}),
                     nan_guard=nan_guard)
    st = ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                        dict(HYPER), mesh=DeviceMesh({"dp": 1},
                                                     devices=[CPU]),
                        nan_guard=nan_guard)
    return jst, st


def _host(raw):
    return np.array(raw, dtype=np.float32)


def _sync_from_jax(st, jst):
    for h, jh in zip(st._train_handles, jst._train_handles):
        h._data.copy_(torch.from_numpy(_host(jh._data)))
    for per, jper in zip(st._opt_state, jst._opt_raws):
        for s, js in zip(per, jper):
            s.copy_(torch.from_numpy(_host(js)))
    for h, jh in zip(st._aux_handles, jst._aux_handles):
        h._rebind(torch.from_numpy(_host(jh._data)))


def _update_errors(got, want, steps):
    """Per tensor, the L2 norm of the difference over that of the JAX
    trainer's step for the tensor (its new momentum)."""
    return [float(np.linalg.norm(g - w) / max(np.linalg.norm(s), 1e-30))
            for g, w, s in zip(got, want, steps)]


@pytest.mark.parametrize("nan_guard", [True, False])
def test_thumbnail_resnet18_steps_match_jax_sharded_trainer(nan_guard):
    jst, st = _pair(nan_guard)
    assert st._param_names == jst._param_names
    assert st._aux_names == jst._aux_names
    assert len(st._param_names) == 60 and len(st._aux_names) == 38
    x, y = _batches()
    for i in range(STEPS):
        _sync_from_jax(st, jst)
        a0 = [_host(h._data) for h in jst._aux_handles]
        want = jst.step(jmx.nd.array(x[i]), jmx.nd.array(y[i])).asscalar()
        got = st.step(mx.nd.array(x[i], ctx=CPU),
                      mx.nd.array(y[i], ctx=CPU)).asscalar()
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        for h, jh, old in zip(st._aux_handles, jst._aux_handles, a0):
            ref = _host(jh._data)
            assert not np.array_equal(ref, old)
            np.testing.assert_allclose(h._data.numpy(), ref, rtol=AUX_TOL,
                                       atol=AUX_TOL * max(
                                           float(np.abs(ref).max()), 1.0))
        moms = [_host(per[0]) for per in jst._opt_raws]
        for got_t, want_t in (
                ([h._data.numpy() for h in st._train_handles],
                 [_host(h._data) for h in jst._train_handles]),
                ([per[0].numpy() for per in st._opt_state], moms)):
            errs = _update_errors(got_t, want_t, moms)
            assert max(errs) <= UPDATE_TOL, (i, max(errs))
    assert st.skipped_steps == 0


def test_a_skipped_step_leaves_running_stats_and_weights_untouched():
    """With ``nan_guard``, a batch holding a NaN skips the update: the
    weights, momenta and running statistics stay as they were, in both
    packages; the next good step writes the statistics again."""
    jst, st = _pair(True)
    x, y = _batches()
    st.step(mx.nd.array(x[0], ctx=CPU), mx.nd.array(y[0], ctx=CPU))
    before = [h._data.clone() for h in st._train_handles + st._aux_handles]
    moms = [per[0].clone() for per in st._opt_state]
    bad = x[1].copy()
    bad[3, 1, 5, 7] = np.nan
    loss = st.step(mx.nd.array(bad, ctx=CPU), mx.nd.array(y[1], ctx=CPU))
    assert np.isnan(loss.asscalar()) and st.skipped_steps == 1
    after = [h._data for h in st._train_handles + st._aux_handles]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert all(torch.equal(a, per[0]) for a, per in zip(moms, st._opt_state))
    jst.step(jmx.nd.array(x[0]), jmx.nd.array(y[0]))
    jaux = [_host(h._data) for h in jst._aux_handles]
    jst.step(jmx.nd.array(bad), jmx.nd.array(y[1]))
    assert jst.skipped_steps == 1
    assert all(np.array_equal(a, _host(h._data))
               for a, h in zip(jaux, jst._aux_handles))
    st.step(mx.nd.array(x[2], ctx=CPU), mx.nd.array(y[2], ctx=CPU))
    assert not torch.equal(before[len(st._train_handles)],
                           st._aux_handles[0]._data)


def test_aux_state_never_reaches_the_optimizer_and_gammas_decay():
    _, st = _pair(False)
    assert not any(n.endswith(("running_mean", "running_var"))
                   for n in st._param_names)
    assert all(n.endswith(("running_mean", "running_var"))
               for n in st._aux_names)
    assert len(st._opt_state) == len(st._param_names)
    wd = dict(zip(st._param_names, st._wd_mult))
    assert all(wd[n] == 1.0 for n in wd if n.endswith(("weight", "gamma")))
    assert all(wd[n] == 0.0 for n in wd if n.endswith(("beta", "bias")))
    # predict runs in eval mode: the running statistics normalise and
    # stay as they are
    stats = [h._data.clone() for h in st._aux_handles]
    x, _ = _batches()
    assert st.predict(mx.nd.array(x[0], ctx=CPU)).shape == (BATCH, CLASSES)
    assert all(torch.equal(a, h._data) for a, h in zip(stats,
                                                       st._aux_handles))


def test_the_bench_config_trains_at_a_small_size():
    """``bench.py:275-303`` with ``BENCH_DTYPE=float32``, cut to a
    thumbnail resnet18_v1, 16 classes and a batch of 4 at 32x32 on the
    CPU: the weights from Xavier, the batch from ``nd.random.uniform``,
    ``nan_guard=False``; the loss stays finite and the running statistics
    move."""
    mx.random.seed(0)
    net = vision.get_model("resnet18_v1", classes=16, thumbnail=True)
    net.initialize(mx.init.Xavier(), ctx=CPU,
                   generator=torch.Generator().manual_seed(0))
    x = mx.nd.random.uniform(shape=(4, 3, 32, 32), ctx=CPU)
    y = mx.nd.array(np.random.RandomState(0).randint(0, 16, 4)
                    .astype(np.float32), ctx=CPU)
    net(x)
    st = ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                        dict(HYPER), mesh=DeviceMesh({"dp": 1},
                                                     devices=[CPU]),
                        nan_guard=False)
    first = net.features[1][0].body[1].running_mean.data()._data.clone()
    losses = [st.step(x, y).asscalar() for _ in range(3)]
    assert all(np.isfinite(losses))
    assert not torch.equal(first, net.features[1][0].body[1]
                           .running_mean.data()._data)


# ---- nd.random ------------------------------------------------------------

def test_uniform_and_normal_shapes_dtypes_ranges_and_moments():
    with CPU:
        u = mx.nd.random.uniform(-2, 3, shape=(200, 500))
        n = mx.nd.random.normal(1.5, 0.5, shape=(100000,))
        b = mx.nd.random.uniform(shape=7, dtype="bfloat16")
    assert u.shape == (200, 500) and u.dtype == torch.float32
    assert u.context == CPU and b.shape == (7,) and b.dtype == torch.bfloat16
    a = u.asnumpy()
    assert a.min() >= -2 and a.max() < 3
    # 1e5 draws: the mean within 5 standard errors, the variance within 2%
    np.testing.assert_allclose(a.mean(), 0.5, atol=5 * 5 / np.sqrt(12e5))
    np.testing.assert_allclose(a.var(), 25 / 12, rtol=0.02)
    v = n.asnumpy()
    np.testing.assert_allclose(v.mean(), 1.5, atol=5 * 0.5 / np.sqrt(1e5))
    np.testing.assert_allclose(v.std(), 0.5, rtol=0.02)
    assert mx.nd.random.randn(2, 3, ctx=CPU).shape == (2, 3)


def test_one_seed_repeats_the_draws_and_the_stream_advances():
    mx.random.seed(42)
    a = mx.nd.random.uniform(shape=(5,), ctx=CPU).asnumpy()
    b = mx.nd.random.uniform(shape=(5,), ctx=CPU).asnumpy()
    mx.random.seed(42)
    assert np.array_equal(a, mx.nd.random.uniform(shape=(5,),
                                                  ctx=CPU).asnumpy())
    assert not np.array_equal(a, b)
    out = mx.nd.zeros((5,), ctx=CPU)
    assert mx.nd.random.normal(shape=(5,), ctx=CPU, out=out) is out
    # the registered op draws from the current context's generator too
    with CPU:
        assert mx.nd.uniform(shape=(3,)).shape == (3,)


def test_the_samplers_not_ported_raise():
    """Named when these samplers raised: now ported, each draws on the
    current context (``tests/test_torch_random_samplers.py`` holds them
    against the JAX package)."""
    with CPU:
        for name in ("gamma", "exponential", "poisson", "negative_binomial",
                     "bernoulli"):
            out = getattr(mx.nd.random, name)(shape=(2,))
            assert out.shape == (2,) and out.context == CPU
        assert mx.nd.random.randint(0, 3, shape=(2,)).shape == (2,)
        data = mx.nd.ones((2, 3))
        assert mx.nd.random.multinomial(data).shape == (2,)
        assert mx.nd.random.shuffle(data).shape == (2, 3)
