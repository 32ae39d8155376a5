"""``gluon.contrib.nn``'s ``Concurrent``, ``HybridConcurrent``,
``Identity``, ``SyncBatchNorm`` and ``PixelShuffle1D/2D/3D`` in the port
against the JAX package's on the CPU: outputs, input gradients and
(SyncBatchNorm) running statistics after a training forward, from the
same seeded numpy inputs and the JAX blocks' weights. Tolerances: float32
at rtol 1e-5, atol 1e-5.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.contrib import nn as jcnn
from mxnet_tpu_torch.gluon.contrib import nn as cnn

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(build):
    """The same block in both packages, the port's weights set to the JAX
    block's after one forward fixed every shape."""
    return build(jmx, jcnn), build(mx, cnn)


def _copy_weights(jblock, block):
    jp = list(jblock.collect_params().values())
    pp = list(block.collect_params().values())
    assert len(jp) == len(pp)
    for j, p in zip(jp, pp):
        p.set_data(mx.nd.array(j.data().asnumpy()))


def _run(m, block, x, record):
    xs = m.nd.array(x)
    if not record:
        return block(xs).asnumpy(), None
    xs.attach_grad()
    with m.autograd.record():
        y = block(xs)
    y.backward(m.nd.array(np.cos(np.arange(y.size, dtype=np.float32))
                          .reshape(y.shape)))
    return y.asnumpy(), xs.grad.asnumpy()


def _concurrent(m, c, hybrid):
    net = (c.HybridConcurrent if hybrid else c.Concurrent)(axis=1)
    net.add(m.gluon.nn.Dense(3), m.gluon.nn.Dense(2, activation="relu"),
            c.Identity())
    net.initialize()
    return net


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("record", [False, True])
def test_concurrent_matches_jax(hybrid, record):
    x = _x(0, 4, 5)
    with mx.cpu():
        jnet, net = _pair(lambda m, c: _concurrent(m, c, hybrid))
        jnet(jmx.nd.array(x))
        net(mx.nd.array(x))
        _copy_weights(jnet, net)
        if hybrid:
            jnet.hybridize()
            net.hybridize()
        want, jg = _run(jmx, jnet, x, record)
        got, pg = _run(mx, net, x, record)
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, want, **TOL)
    if record:
        np.testing.assert_allclose(pg, jg, **TOL)


def test_hybrid_concurrent_traces_into_a_symbol():
    with mx.cpu():
        net = _concurrent(mx, cnn, True)
        net(mx.nd.array(_x(1, 2, 5)))
        out = net(mx.sym.var("data"))
        assert out.infer_shape(data=(2, 5))[1] == [(2, 10)]


@pytest.mark.parametrize("record", [False, True])
def test_sync_batchnorm_matches_jax_and_updates_its_statistics(record):
    x = _x(2, 6, 3, 4, 4) * 2 + 1
    with mx.cpu():
        jnet, net = _pair(lambda m, c: c.SyncBatchNorm(in_channels=3,
                                                       num_devices=1))
        for b in (jnet, net):
            b.initialize()
        want, jg = _run(jmx, jnet, x, record)
        got, pg = _run(mx, net, x, record)
    np.testing.assert_allclose(got, want, **TOL)
    if record:
        np.testing.assert_allclose(pg, jg, rtol=1e-4, atol=1e-5)
    for name in ("running_mean", "running_var"):
        j = getattr(jnet, name).data().asnumpy()
        p = getattr(net, name).data().asnumpy()
        np.testing.assert_allclose(p, j, **TOL)
    assert (np.abs(net.running_mean.data().asnumpy()) > 0).any() == record


@pytest.mark.parametrize("cls,factor,shape", [
    ("PixelShuffle1D", 3, (2, 6, 5)),
    ("PixelShuffle2D", (2, 3), (2, 12, 3, 4)),
    ("PixelShuffle3D", 2, (1, 16, 2, 3, 2)),
])
@pytest.mark.parametrize("hybrid", [False, True])
def test_pixel_shuffle_matches_jax(cls, factor, shape, hybrid):
    x = _x(3, *shape)
    with mx.cpu():
        jnet, net = _pair(lambda m, c: getattr(c, cls)(factor))
        if hybrid:
            jnet.hybridize()
            net.hybridize()
        want, jg = _run(jmx, jnet, x, True)
        got, pg = _run(mx, net, x, True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pg, jg)
    assert repr(net) == repr(jnet)
