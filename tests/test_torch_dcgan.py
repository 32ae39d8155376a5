"""``examples/gluon/dcgan.py`` in both packages on the CPU: its networks
(``build_nets``: Conv2DTranspose, BatchNorm, LeakyReLU(0.2)) from the
same weights, and two iterations of its loop (the D step on real and
detached fake batches, then the G step, two ``gluon.Trainer`` "adam"
with lr 2e-3 and beta1 0.5, ``SigmoidBinaryCrossEntropyLoss``) on the
same numpy images and noise.

Tolerances: the losses of each iteration at rtol 1e-5; every parameter
after the two iterations within 1e-2 * lr (Adam's first steps move each
weight by about lr whatever the gradient's size, so this is a hundredth
of a step; largest difference met: 3e-7 absolute).
"""
import importlib.util
from pathlib import Path

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.convert import load_jax_params

ROOT = Path(__file__).resolve().parents[1]
CPU = mx.cpu()
B, NZ, LR = 32, 16, 2e-3


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


def _iterations(pkg, g, d, data, noises, ctx):
    arr = (lambda a: pkg.nd.array(a, ctx=ctx)) if ctx else pkg.nd.array
    tg = pkg.gluon.Trainer(g.collect_params(), "adam",
                           {"learning_rate": LR, "beta1": 0.5})
    td = pkg.gluon.Trainer(d.collect_params(), "adam",
                           {"learning_rate": LR, "beta1": 0.5})
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
        td.step(B)
        with pkg.autograd.record():
            loss_g = bce(d(g(z)).reshape((-1,)), ones)
        loss_g.backward()
        tg.step(B)
        losses.append((float(loss_d.mean().asscalar()),
                       float(loss_g.mean().asscalar())))
    return losses


def test_two_dcgan_iterations_match_jax():
    ex = _example()
    rs = np.random.RandomState(0)
    real = _images(2 * B, rs)
    data = [real[:B], real[B:]]
    noises = [rs.randn(B, NZ, 1, 1).astype(np.float32) for _ in range(2)]
    jg, jd = _nets(jmx, ex, None)
    g, d = _nets(mx, ex, CPU)
    for block, jblock in ((g, jg), (d, jd)):
        load_jax_params(block, {
            n: p.data().asnumpy()
            for n, p in jblock._collect_params_with_structure().items()})
    want = _iterations(jmx, jg, jd, data, noises, None)
    got = _iterations(mx, g, d, data, noises, CPU)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for block, jblock in ((g, jg), (d, jd)):
        jp = jblock._collect_params_with_structure()
        for n, p in block._collect_params_with_structure().items():
            np.testing.assert_allclose(p.data().asnumpy(),
                                       jp[n].data().asnumpy(), rtol=0,
                                       atol=1e-2 * LR, err_msg=n)
    assert all(np.isfinite(got).ravel())
