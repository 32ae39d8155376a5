"""AMP (``mxnet_tpu_torch/amp/``, ``_amp_core.py`` and its hooks in
``ndarray._invoke``, ``Symbol._build_eval`` and the compile service's
keys) against the JAX package's, on the CPU: the AMP tests of
``tests/test_subsystems.py:233-320`` run in both packages, the eager
outputs compared from the same numpy weights, and the captured-block
cases read the compile service's statistics (on the CPU an entry is a
plain call, so a new entry shows as a miss).

Tolerances: the port and the JAX package run the same bfloat16 products
with float32 accumulation, rounded once to bfloat16; their outputs agree
to ``BF16_RTOL`` (two bfloat16 ulps) of the largest output. Everything
else (dtypes, entry counts, the loss scale) is exact."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import amp as jamp
from mxnet_tpu_torch import _amp_core, amp
from mxnet_tpu_torch.base import dtype_name

BF16_RTOL = 2 ** -7
CPU = mx.cpu()


def _dt(x):
    d = x.dtype
    return dtype_name(d) if isinstance(d, torch.dtype) else np.dtype(d).name


@pytest.fixture
def amp_off():
    yield
    amp.turn_off()
    jamp.turn_off()


def _mlp(m, weights=None):
    nn = m.gluon.nn
    net = nn.Sequential()
    net.add(nn.Dense(16, activation="relu", in_units=8), nn.Dense(4,
                                                                  in_units=16))
    net.initialize(m.init.Xavier(), ctx=CPU if m is mx else None)
    if weights is not None:
        for p, w in zip(net.collect_params().values(), weights):
            p.set_data(m.nd.array(w, ctx=CPU) if m is mx else m.nd.array(w))
    return net


def _weights(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.uniform(-.5, .5, (16, 8)).astype(np.float32),
            (0.1 * rs.randn(16)).astype(np.float32),
            rs.uniform(-.5, .5, (4, 16)).astype(np.float32),
            (0.1 * rs.randn(4)).astype(np.float32)]


def test_amp_eager_and_hybrid_cast_match_jax(amp_off):
    w = _weights()
    x = np.random.RandomState(1).rand(4, 8).astype(np.float32)
    with mx.cpu():
        net = _mlp(mx, w)
        ref = net(mx.nd.array(x)).asnumpy()
        amp.init("bfloat16")
        out = net(mx.nd.array(x))
        net.hybridize()
        out_h = net(mx.nd.array(x))
    jnet = _mlp(jmx, w)
    jamp.init("bfloat16")
    jout = jnet(jmx.nd.array(x))
    assert _dt(out) == _dt(out_h) == _dt(jout) == "bfloat16"
    got = out.asnumpy().astype(np.float32)
    want = jout.asnumpy().astype(np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_RTOL * scale)
    np.testing.assert_array_equal(out_h.asnumpy().astype(np.float32), got)
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("m", [jmx, mx], ids=["jax", "port"])
def test_amp_fp32_ops_stay_fp32_and_widest_promotes(m, amp_off):
    (jamp if m is jmx else amp).init("bfloat16")
    kw = {"ctx": CPU} if m is mx else {}
    x = m.nd.ones((2, 3), **kw).astype("bfloat16")
    assert _dt(m.nd.softmax(x)) == "float32"
    assert _dt(m.nd.sum(x)) == "float32"
    y = m.nd.ones((2, 3), **kw)
    assert _dt(m.nd.broadcast_add(x, y)) == "float32"
    assert _dt(m.nd.relu(x)) == "bfloat16"


@pytest.mark.parametrize("m", [jmx, mx], ids=["jax", "port"])
def test_amp_symbol_path(m, amp_off):
    data = m.sym.var("data")
    fc = m.sym.FullyConnected(data, num_hidden=4, name="fc")
    sm = m.sym.softmax(fc)
    (jamp if m is jmx else amp).init("bfloat16")
    ex = sm.simple_bind(m.cpu(), data=(2, 8))
    x = np.random.rand(2, 8).astype(np.float32)
    out = ex.forward(is_train=False, data=m.nd.array(x, ctx=m.cpu())
                     if m is mx else x)
    assert _dt(out[0]) == "float32"
    internals = fc.simple_bind(m.cpu(), data=(2, 8))
    assert _dt(internals.forward(is_train=False, data=m.nd.array(
        x, ctx=m.cpu()) if m is mx else x)[0]) == "bfloat16"


def test_amp_training_converges(amp_off):
    np.random.seed(0)
    mx.random.seed(0)
    X = np.random.randn(128, 10).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    amp.init("bfloat16")
    with mx.cpu():
        nn = mx.gluon.nn
        net = nn.Sequential()
        net.add(nn.Dense(16, activation="relu"), nn.Dense(2))
        net.initialize(mx.init.Xavier())
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        amp.init_trainer(trainer)
        lfn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        Xn, yn = mx.nd.array(X), mx.nd.array(y)
        losses = []
        for _ in range(40):
            with mx.autograd.record():
                loss = lfn(net(Xn), yn).mean()
                with amp.scale_loss(loss, trainer) as scaled:
                    pass
            scaled.backward()
            assert not amp.unscale(trainer)
            trainer.step(1)
            losses.append(float(loss.asscalar()))
    assert _dt(loss) == "float32"   # log_softmax runs in float32
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    assert all(_dt(p.data()) == "float32"
               for p in net.collect_params().values())


@pytest.mark.parametrize("scaler_cls", [jamp.LossScaler, amp.LossScaler],
                         ids=["jax", "port"])
def test_amp_loss_scaler_dynamics(scaler_cls):
    scaler = scaler_cls(init_scale=1024, scale_factor=2, scale_window=2)
    scaler.update_scale(overflow=True)
    assert scaler.loss_scale == 512
    scaler.update_scale(False)
    scaler.update_scale(False)
    assert scaler.loss_scale == 1024
    scaler.update_scale(True)
    scaler.update_scale(True)
    assert scaler.loss_scale == 256


def test_has_overflow_reads_one_flag_over_mixed_gradients():
    scaler = amp.LossScaler()
    grads = [torch.ones(5), torch.ones(3, dtype=torch.float16),
             torch.ones(2, 2, dtype=torch.bfloat16)]
    before = [g.clone() for g in grads]
    assert not scaler.has_overflow(grads)
    for g, b in zip(grads, before):
        assert torch.equal(g, b)          # the check leaves them as they are
    grads[1][2] = float("inf")
    assert scaler.has_overflow(grads)
    grads[1][2] = 1.0
    grads[2][1, 1] = float("nan")
    assert scaler.has_overflow(grads)
    assert (scaler._total, scaler._skipped) == (3, 2)


def test_amp_convert_hybrid_block(amp_off):
    with mx.cpu():
        net = mx.gluon.nn.Dense(4)
        net.initialize()
        x = mx.nd.ones((2, 8))
        net(x)
        net2 = amp.convert_hybrid_block(net, "bfloat16")
        out = net2(x)
    assert net2 is net and net._active
    assert _dt(out) == "bfloat16"


def test_amp_generation_invalidates_captured_entries(amp_off):
    """A hybridized block's entry made before ``amp.init`` is not reused
    after it (a new entry: a miss), nor after ``turn_off``; the JAX
    package's cached op retraces the same way."""
    with mx.cpu():
        net = mx.gluon.nn.Dense(3)
        net.initialize()
        net.hybridize()
        x = mx.nd.ones((2, 5))
        net(x)                      # resolves the deferred shapes
        out1 = net(x)
        st1 = net._cached_op.stats()
        out1b = net(x)
        st1b = net._cached_op.stats()
        gen = _amp_core.GEN
        amp.init("bfloat16")
        assert _amp_core.GEN == gen + 1
        out2 = net(x)
        st2 = net._cached_op.stats()
        amp.turn_off()
        out3 = net(x)
        st3 = net._cached_op.stats()
    assert _dt(out1) == _dt(out1b) == "float32"
    assert _dt(out2) == "bfloat16" and _dt(out3) == "float32"
    assert st1b["misses"] == st1["misses"]          # the same entry
    assert st2["misses"] == st1b["misses"] + 1      # captured anew
    assert st3["misses"] == st2["misses"] + 1
    np.testing.assert_array_equal(out3.asnumpy(), out1.asnumpy())
    jnet = jmx.gluon.nn.Dense(3)
    jnet.initialize()
    jnet.hybridize()
    jx = jmx.nd.ones((2, 5))
    assert _dt(jnet(jx)) == "float32"
    jamp.init("bfloat16")
    assert _dt(jnet(jx)) == "bfloat16"
    jamp.turn_off()
    assert _dt(jnet(jx)) == "float32"


def test_cache_stale_stamps_the_generation(amp_off):
    class Holder:
        pass

    h = Holder()
    assert not _amp_core.cache_stale(h)
    assert not _amp_core.cache_stale(h)
    amp.init()
    assert _amp_core.cache_stale(h)
    assert not _amp_core.cache_stale(h)


def _fp16_step(m, force_overflow):
    """One float16 AMP step of a Dense layer; returns (overflow, scale
    before, scale after, the weights after the step)."""
    (jamp if m is jmx else amp).init("float16")
    kw = {"ctx": CPU} if m is mx else {}
    net = m.gluon.nn.Dense(4, in_units=8)
    net.initialize(m.init.One(), **kw)
    trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
    a = jamp if m is jmx else amp
    a.init_trainer(trainer)
    scale = trainer._amp_loss_scaler.loss_scale
    x = m.nd.ones((2, 8), **kw)
    if force_overflow:
        x = x * 1e4           # x * w sums past float16's range
    with m.autograd.record():
        loss = net(x).mean()
        with a.scale_loss(loss, trainer) as scaled:
            pass
    scaled.backward()
    overflow = a.unscale(trainer)
    after = trainer._amp_loss_scaler.loss_scale
    trainer.step(1)
    return overflow, scale, after, net.weight.data().asnumpy()


@pytest.mark.parametrize("m", [jmx, mx], ids=["jax", "port"])
def test_fp16_overflow_halves_the_scale(m, amp_off):
    overflow, before, after, w = _fp16_step(m, False)
    assert not overflow and after == before == 2.0 ** 16
    assert np.isfinite(w).all()
    overflow, before, after, _ = _fp16_step(m, True)
    assert overflow and after == before / 2


@pytest.mark.parametrize("m", [jmx, mx], ids=["jax", "port"])
def test_c30_a_step_after_a_reported_overflow_is_not_skipped(m, amp_off):
    """ROADMAP C30: both packages leave the skip to the caller (the
    ``unscale`` contract): a ``Trainer.step`` after an overflow applies
    the non-finite gradient. MXNet 1.x's optimizer would skip it."""
    overflow, _, _, w = _fp16_step(m, True)
    assert overflow
    assert not np.isfinite(w).all()
