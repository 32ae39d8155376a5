"""``examples/gluon/dcgan.py`` in both packages on the CPU: its networks
(``build_nets``: Conv2DTranspose, BatchNorm, LeakyReLU(0.2)) from the
same weights, and two iterations of its loop (the D step on real and
detached fake batches, then the G step, two ``gluon.Trainer`` "adam"
with lr 2e-3 and beta1 0.5, ``SigmoidBinaryCrossEntropyLoss``) on the
same numpy images and noise.

The JAX nets draw their initial weights after ``jmx.random.seed(seed)``
in the test itself, over several seeds, so the global RNG state that
earlier test files leave behind never picks the weights.

Tolerances: the losses of each iteration at rtol 1e-5; the first
step's gradients of every parameter (from the same weights, so rounding
alone separates them) within 1e-4 of the tensor's largest magnitude
(largest met: 1.1e-5). After the two iterations, a weight whose gradient
at each step is above that step's float32 noise of its tensor in both
packages, ``SURE`` times the largest difference between the packages'
gradients of the tensor, is held within 1e-2 * lr: Adam's step then
differs by at most 2 / ``SURE`` of lr. The noise grows at the second
step: a weight whose first gradient had a sign that rounding decided was
stepped by lr, in opposite directions in the two packages, and every
second gradient moved with it. Any other weight is held within twice
what two Adam steps can move a weight (``TWO_STEPS``: lr at the first
step, at most ``STEP2`` * lr at the second).
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.convert import load_jax_params

ROOT = Path(__file__).resolve().parents[1]
CPU = mx.cpu()
B, NZ, LR = 32, 16, 2e-3
BETA1, BETA2 = 0.5, 0.999
SURE = 200     # a gradient this many times its tensor's noise
# the largest |m_hat / sqrt(v_hat)| of Adam's second step over gradient
# pairs (g1, g2): |b1 g1 + g2| (1 - b1) / (1 - b1^2) against
# sqrt((1 - b2) (b2 g1^2 + g2^2) / (1 - b2^2)), bounded by Cauchy-Schwarz
# (1.054 at beta1 0.5, beta2 0.999); the first step moves by lr exactly
STEP2 = math.sqrt(BETA1 ** 2 / BETA2 + 1) * math.sqrt(1 + BETA2) / (1 + BETA1)
TWO_STEPS = LR * (1 + STEP2)


def _example():
    spec = importlib.util.spec_from_file_location(
        "dcgan", ROOT / "examples" / "gluon" / "dcgan.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _images(n, rs):
    """The example's synthetic 16x16 images (``dcgan.py:62-69``)."""
    yy, xx = np.mgrid[0:16, 0:16] / 15.0
    centers = rs.rand(n, 2)
    real = np.tanh(3.0 * np.exp(
        -(((xx[None] - centers[:, 0, None, None]) ** 2 +
           (yy[None] - centers[:, 1, None, None]) ** 2) / 0.05)) - 0.5)
    return real[:, None].astype(np.float32)


def _nets(pkg, ex, ctx):
    with pkg.name.NameManager():
        g, d = ex.build_nets(pkg.gluon.nn)
    kw = {"ctx": ctx} if ctx else {}
    g.initialize(pkg.init.Normal(0.02), **kw)
    d.initialize(pkg.init.Normal(0.02), **kw)
    noise = pkg.nd.zeros((2, NZ, 1, 1), **kw)
    d(g(noise))
    return g, d


def _grads(block):
    return {n: p.grad().asnumpy().copy()
            for n, p in block._collect_params_with_structure().items()
            if p.grad_req != "null"}


def _iterations(pkg, g, d, data, noises, ctx, grads):
    """The example's loop; ``grads`` gets each step's gradients by
    parameter name (``("g", name)`` or ``("d", name)``)."""
    arr = (lambda a: pkg.nd.array(a, ctx=ctx)) if ctx else pkg.nd.array
    tg = pkg.gluon.Trainer(g.collect_params(), "adam",
                           {"learning_rate": LR, "beta1": BETA1})
    td = pkg.gluon.Trainer(d.collect_params(), "adam",
                           {"learning_rate": LR, "beta1": BETA1})
    bce = pkg.gluon.loss.SigmoidBinaryCrossEntropyLoss()
    ones, zeros = arr(np.ones(B, np.float32)), arr(np.zeros(B, np.float32))
    losses = []
    for x, z in zip(data, noises):
        x, z = arr(x), arr(z)
        fake = g(z)
        with pkg.autograd.record():
            out_real = d(x).reshape((-1,))
            out_fake = d(fake.detach()).reshape((-1,))
            loss_d = bce(out_real, ones) + bce(out_fake, zeros)
        loss_d.backward()
        for n, v in _grads(d).items():
            grads.setdefault(("d", n), []).append(v)
        td.step(B)
        with pkg.autograd.record():
            loss_g = bce(d(g(z)).reshape((-1,)), ones)
        loss_g.backward()
        for n, v in _grads(g).items():
            grads.setdefault(("g", n), []).append(v)
        tg.step(B)
        losses.append((float(loss_d.mean().asscalar()),
                       float(loss_g.mean().asscalar())))
    return losses


def _sure(port, jax_):
    """True where both packages' gradient is above ``SURE`` times the
    tensor's noise (the largest difference between them) at every
    step."""
    sure = np.ones(port[0].shape, bool)
    for a, b in zip(port, jax_):
        noise = np.abs(a - b).max()
        sure &= (np.abs(a) > SURE * noise) & (np.abs(b) > SURE * noise)
    return sure


@pytest.mark.parametrize("seed", [101, 102, 103, 104, 105, 106, 107])
def test_two_dcgan_iterations_match_jax(seed):
    ex = _example()
    rs = np.random.RandomState(0)
    real = _images(2 * B, rs)
    data = [real[:B], real[B:]]
    noises = [rs.randn(B, NZ, 1, 1).astype(np.float32) for _ in range(2)]
    jmx.random.seed(seed)
    jg, jd = _nets(jmx, ex, None)
    g, d = _nets(mx, ex, CPU)
    for block, jblock in ((g, jg), (d, jd)):
        load_jax_params(block, {
            n: p.data().asnumpy()
            for n, p in jblock._collect_params_with_structure().items()})
    jgrads, pgrads = {}, {}
    want = _iterations(jmx, jg, jd, data, noises, None, jgrads)
    got = _iterations(mx, g, d, data, noises, CPU, pgrads)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for key, steps in pgrads.items():
        first, jfirst = steps[0], jgrads[key][0]
        assert np.abs(first - jfirst).max() <= 1e-4 * np.abs(jfirst).max(), \
            (key, seed)
    for tag, block, jblock in (("g", g, jg), ("d", d, jd)):
        jp = jblock._collect_params_with_structure()
        for n, p in block._collect_params_with_structure().items():
            diff = np.abs(p.data().asnumpy() - jp[n].data().asnumpy())
            if (tag, n) not in pgrads:   # BatchNorm's running statistics
                np.testing.assert_allclose(p.data().asnumpy(),
                                           jp[n].data().asnumpy(), rtol=0,
                                           atol=1e-2 * LR, err_msg=n)
                continue
            sure = _sure(pgrads[tag, n], jgrads[tag, n])
            assert diff[sure].max(initial=0.0) <= 1e-2 * LR, (n, seed)
            assert diff[~sure].max(initial=0.0) <= 2 * TWO_STEPS, (n, seed)
    assert all(np.isfinite(got).ravel())
