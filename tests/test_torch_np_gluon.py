"""Gluon under ``npx.set_np()``, the port against the JAX package: a
2-layer, 64-wide classifier fed ``mx.np`` arrays and trained three steps
with ``gluon.Trainer`` (Adam) from the same weights, the loss written as
an MXNet 1.x np user writes it (``-npx.pick(npx.log_softmax(logits),
label).mean()``). Losses and weights after each step agree within rtol
1e-5 (atol 1e-6); the outputs and losses are ``mx.np.ndarray`` and the
parameters' ``data()``/``grad()`` NDArray, in both packages. The same
steps hybridized give the port's eager numbers bit for bit.

Two differences kept in the reference (ROADMAP C):

* C33: the JAX ``npx.softmax`` drops ``length``; the port masks each row
  past its length, as MXNet 1.x's ``use_length=True``.
* C34: a hybridized JAX block fed ``mx.np`` arrays returns NDArray; the
  port's returns ``mx.np.ndarray``, as MXNet 1.x does under ``use_np``.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import np, npx

CPU = mx.cpu()
BATCH, IN, UNITS, CLASSES, STEPS = 8, 16, 64, 4, 3
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _np_mode():
    with CPU:
        npx.set_np()
        jmx.npx.set_np()
        yield
    npx.reset_np()
    jmx.npx.reset_np()


def _net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(UNITS, activation="relu", in_units=IN),
            pkg.gluon.nn.Dense(CLASSES, in_units=UNITS))
    return net


def _pair():
    """The two nets from one set of weights (the JAX initializer's, from
    one seed at every call)."""
    jmx.random.seed(7)
    jnet = _net(jmx)
    jnet.initialize(jmx.init.Xavier())
    pnet = _net(mx)
    pnet.initialize(ctx=CPU)
    for p, j in zip(pnet.collect_params().values(),
                    jnet.collect_params().values()):
        assert p.shape == j.shape
        p.set_data(mx.nd.array(j.data().asnumpy(), ctx=CPU))
    return pnet, jnet


def _batches():
    rs = onp.random.RandomState(0)
    return [(rs.randn(BATCH, IN).astype(onp.float32),
             rs.randint(0, CLASSES, BATCH).astype(onp.int32))
            for _ in range(STEPS)]


def _train(pkg, m, x_mod, net, batches, hybridize=False):
    if hybridize:
        net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 1e-2})
    losses, weights, classes = [], [], []
    for x, y in batches:
        xb, yb = m.array(x), m.array(y)
        with pkg.autograd.record():
            logits = net(xb)
            loss = -x_mod.pick(x_mod.log_softmax(logits), yb).mean()
        loss.backward()
        trainer.step(1)
        classes.append((type(logits), type(loss)))
        losses.append(float(loss.item()))
        weights.append([p.data().asnumpy()
                        for p in net.collect_params().values()])
    params = list(net.collect_params().values())
    return losses, weights, classes, params


def test_np_mode_classifier_steps_match_the_jax_package():
    pnet, jnet = _pair()
    batches = _batches()
    pl, pw, pc, pparams = _train(mx, np, npx, pnet, batches)
    jl, jw, jc, jparams = _train(jmx, jmx.np, jmx.npx, jnet, batches)
    onp.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
    for ps, js in zip(pw, jw):
        for p, j in zip(ps, js):
            onp.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)
    assert all(c == (np.ndarray, np.ndarray) for c in pc)
    assert all(c == (jmx.np.ndarray, jmx.np.ndarray) for c in jc)
    # the parameters stay NDArray in both packages
    assert type(pparams[0].data()) is mx.nd.NDArray
    assert type(pparams[0].grad()) is mx.nd.NDArray
    assert type(jparams[0].data()) is jmx.nd.NDArray
    assert type(jparams[0].grad()) is jmx.nd.NDArray
    assert pl[-1] < pl[0]


def test_np_mode_hybridized_steps_equal_eager_bit_for_bit():
    batches = _batches()
    eager, _ = _pair()
    hybrid, _ = _pair()
    el, ew, _, _ = _train(mx, np, npx, eager, batches)
    hl, hw, hc, _ = _train(mx, np, npx, hybrid, batches, hybridize=True)
    assert el == hl
    for es, hs in zip(ew, hw):
        for e, h in zip(es, hs):
            onp.testing.assert_array_equal(e, h)
    assert all(c == (np.ndarray, np.ndarray) for c in hc)


def test_np_mode_equals_nd_mode_bit_for_bit():
    """Only the wrapper class differs between the frontends: the same
    steps in mx.nd give the np-mode numbers bit for bit."""
    batches = _batches()
    a, _ = _pair()
    b, _ = _pair()
    nl, nw, nc, _ = _train(mx, mx.nd, mx.nd, b,
                           [(x, y.astype(onp.float32)) for x, y in batches])
    pl, pw, _, _ = _train(mx, np, npx, a, batches)
    assert nl == pl
    for ns, ps in zip(nw, pw):
        for n, p in zip(ns, ps):
            onp.testing.assert_array_equal(n, p)
    assert all(c == (mx.nd.NDArray, mx.nd.NDArray) for c in nc)


def test_c34_hybridized_blocks_return_np_arrays_unlike_the_jax_package():
    pnet, jnet = _pair()
    x = onp.random.RandomState(1).randn(BATCH, IN).astype(onp.float32)
    pnet.hybridize()
    jnet.hybridize()
    for _ in range(2):      # the first call and a captured one
        pout = pnet(np.array(x))
        jout = jnet(jmx.np.array(x))
        assert type(pout) is np.ndarray
        assert type(jout) is jmx.nd.NDArray     # C34, the JAX package
        onp.testing.assert_allclose(pout.asnumpy(), jout.asnumpy(),
                                    rtol=RTOL, atol=1e-5)
    # the legacy frontend stays NDArray
    assert type(pnet(mx.nd.array(x))) is mx.nd.NDArray


def test_c33_softmax_length_masks_unlike_the_jax_package():
    x = onp.random.RandomState(2).randn(3, 5).astype(onp.float32)
    length = onp.array([2, 5, 1], onp.int32)
    p = npx.softmax(np.array(x), length=np.array(length)).asnumpy()
    j = jmx.npx.softmax(jmx.np.array(x),
                        length=jmx.np.array(length)).asnumpy()
    e = onp.exp(x - x.max(-1, keepdims=True))
    # JAX: length is dropped, every row is the plain softmax
    onp.testing.assert_allclose(j, e / e.sum(-1, keepdims=True), rtol=1e-5)
    mask = onp.arange(5)[None, :] < length[:, None]
    em = onp.where(mask, onp.exp(x - onp.where(mask, x, -onp.inf).max(
        -1, keepdims=True)), 0.0)
    onp.testing.assert_allclose(p, em / em.sum(-1, keepdims=True),
                                rtol=1e-5, atol=1e-7)
    assert (p[~mask] == 0).all()


def test_gluon_loss_takes_np_arrays_unchanged():
    """``gluon.loss`` on mx.np arrays: an mx.np result equal to the same
    loss on NDArrays bit for bit, in both packages' classes."""
    rs = onp.random.RandomState(3)
    logits = rs.randn(BATCH, CLASSES).astype(onp.float32)
    label = rs.randint(0, CLASSES, BATCH).astype(onp.float32)
    for pkg, m in ((mx, np), (jmx, jmx.np)):
        loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        got = loss(m.array(logits), m.array(label))
        want = loss(pkg.nd.array(logits), pkg.nd.array(label))
        assert type(got) is m.ndarray
        onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
