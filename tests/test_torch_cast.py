"""``Block.cast`` and the bfloat16 forward on the CPU against the JAX
package.

Every parameter's dtype after ``cast("bfloat16")`` equals the JAX
package's (BatchNorm's gamma, beta and running statistics stay float32),
whether the cast comes before the deferred initialization, as
``bench.py:199-208`` does it, or after. Each op of the ResNet path on
bfloat16 data is held against the JAX op on the same numpy inputs.

Tolerances, in bfloat16 units: one ulp of a value ``v`` is ``2**(e - 7)``
for ``2**e <= |v| < 2**(e + 1)``, so one ulp of the output's largest
magnitude ``M`` is at most ``2**-7 * M``, the bound used here
(``ULP``). Measured on these inputs: max pooling, ReLU, the cast and the
adaptive pooling agree bit for bit; the convolution, the dense product,
3x3 average pooling, BatchNorm (train and eval) and the cross entropy
differ from the JAX op by at most one ulp in 5-47% of the elements
(PyTorch rounds each op's result to bfloat16, XLA's CPU backend keeps
float32 across a fused chain and rounds once). BatchNorm normalises in
float32 inside ``F.batch_norm`` (on the card PyTorch's own kernels:
PyTorch sends no bfloat16 BatchNorm to cuDNN) and rounds once, where the
JAX op rounds the mean to bfloat16 first: on a
(8, 16, 12, 12) input 21% of the port's outputs differ from the JAX
op's by one ulp (max 0.03125 at |out| < 5.7), against 18% for the JAX
order computed op by op in PyTorch (``PERF.md`` section 7 says why the
fused call stays). Global average pooling: the JAX op sums the window in
bfloat16 and is off the float64 mean by up to 3.3e-3 at 0.2, where the
port's mean rounds once (3.5e-4), so the two are held to 4 ulps and the
port to half an ulp of the float64 mean. The thumbnail resnet18_v1's
logits differ by at most 1.2% (eval mode) and 2.1% (train mode) of the
largest logit over weight seeds 0-3, with every class the same; they are
held to ``LOGIT_TOL`` = 2**-5 of it and the same class.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision

CPU = mx.cpu()
ULP = 2.0 ** -7
LOGIT_TOL = 2.0 ** -5


def _host(a):
    r = a._data
    if isinstance(r, torch.Tensor):
        return r.detach().float().numpy()
    return np.asarray(jnp.asarray(r).astype(jnp.float32))


def _dtype_name(a):
    return str(a._data.dtype).replace("torch.", "")


def _bf(a, j=False):
    if j:
        return jmx.nd.array(a).astype("bfloat16")
    return mx.nd.array(a, ctx=CPU).astype("bfloat16")


def _close(got, want, ulps=1):
    g, w = _host(got), _host(want)
    assert _dtype_name(got) == _dtype_name(want)
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=ulps * ULP * float(np.abs(w).max()))


def _dtypes(net):
    return {n: _dtype_name(p.data())
            for n, p in net._collect_params_with_structure().items()}


@pytest.mark.parametrize("before_init", [True, False])
def test_cast_dtypes_equal_the_jax_package(before_init):
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    jnet = jvision.get_model("resnet18_v1", classes=10, thumbnail=True)
    net = vision.get_model("resnet18_v1", classes=10, thumbnail=True)
    jnet.initialize(jmx.init.Xavier())
    net.initialize(mx.init.Xavier(), ctx=CPU)
    if before_init:  # bench.py's order: deferred shapes come at the forward
        jnet.cast("bfloat16")
        net.cast("bfloat16")
        jnet(_bf(x, True))
        net(_bf(x))
    else:
        jnet(jmx.nd.array(x))
        net(mx.nd.array(x, ctx=CPU))
        jnet.cast("bfloat16")
        net.cast("bfloat16")
    got, want = _dtypes(net), _dtypes(jnet)
    assert got == want
    assert {n for n, d in got.items() if d == "float32"} == \
        {n for n in got if n.split(".")[-1] in (
            "gamma", "beta", "running_mean", "running_var")}
    assert "bfloat16" in set(got.values())
    net.cast("float32")
    assert set(_dtypes(net).values()) == {"float32"}


def test_cast_remakes_the_gradient_in_the_new_dtype():
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(4, in_units=3),
                mx.gluon.nn.BatchNorm(in_channels=4))
    net.initialize(ctx=CPU)
    net.hybridize(static_alloc=True, static_shape=True)
    x = mx.nd.array(np.ones((2, 3), np.float32), ctx=CPU)
    with mx.autograd.record():
        net(x).sum().backward()
    net.cast("bfloat16")
    dense, bn = net[0], net[1]
    with mx.autograd.record():
        out = net(x.astype("bfloat16"))
        out.astype("float32").sum().backward()
    assert out._data.dtype == torch.bfloat16
    assert dense.weight.grad()._data.dtype == torch.bfloat16
    assert bn.gamma.grad()._data.dtype == torch.float32
    assert bn.running_mean.data()._data.dtype == torch.float32
    with pytest.raises(RuntimeError, match="grad_req='null'"):
        bn.running_mean.grad()


def test_astype_and_uniform_in_bfloat16():
    x = np.random.RandomState(1).randn(5, 7).astype(np.float32)
    _close(_bf(x), _bf(x, True), ulps=0)
    u = mx.nd.random.uniform(shape=(64, 64), ctx=CPU, dtype="bfloat16")
    assert u._data.dtype == torch.bfloat16
    assert 0 <= float(u._data.float().min()) and \
        float(u._data.float().max()) <= 1
    assert _host(_bf(x).astype("float32")).dtype == np.float32


RS = np.random.RandomState(0)
X = RS.randn(4, 8, 10, 10).astype(np.float32)
W = (RS.randn(16, 8, 3, 3) * 0.2).astype(np.float32)
B = RS.randn(16).astype(np.float32)


def _conv(F, bf, stride, bias):
    return F.Convolution(bf(X), bf(W), bf(B) if bias else None,
                         kernel=(3, 3), stride=stride, pad=(1, 1),
                         num_filter=16, no_bias=not bias)


@pytest.mark.parametrize("stride,bias", [((1, 1), True), ((2, 2), False)])
def test_convolution_in_bfloat16(stride, bias):
    _close(_conv(mx.nd, _bf, stride, bias),
           _conv(jmx.nd, lambda a: _bf(a, True), stride, bias))


@pytest.mark.parametrize("pool_type,ulps", [("max", 0), ("avg", 1)])
def test_pooling_in_bfloat16(pool_type, ulps):
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type=pool_type)
    _close(mx.nd.Pooling(_bf(X), **kw), jmx.nd.Pooling(_bf(X, True), **kw),
           ulps)


def test_global_average_pooling_in_bfloat16():
    kw = dict(kernel=(1, 1), global_pool=True, pool_type="avg")
    got = mx.nd.Pooling(_bf(X), **kw)
    _close(got, jmx.nd.Pooling(_bf(X, True), **kw), ulps=4)
    exact = _bf(X)._data.double().mean(dim=(2, 3), keepdim=True)
    err = (got._data.double() - exact).abs()
    assert bool((err <= exact.abs() * 2.0 ** -8 + 1e-30).all())
    _close(mx.nd.contrib.AdaptiveAvgPooling2D(_bf(X), output_size=(1, 1)),
           jmx.nd.contrib.AdaptiveAvgPooling2D(_bf(X, True),
                                               output_size=(1, 1)), ulps=0)


def test_dense_and_relu_in_bfloat16():
    w = (RS.randn(5, 800) * 0.05).astype(np.float32)
    b = RS.randn(5).astype(np.float32)
    _close(mx.nd.FullyConnected(_bf(X), _bf(w), _bf(b), num_hidden=5),
           jmx.nd.FullyConnected(_bf(X, True), _bf(w, True), _bf(b, True),
                                 num_hidden=5))
    _close(mx.nd.Activation(_bf(X), act_type="relu"),
           jmx.nd.Activation(_bf(X, True), act_type="relu"), ulps=0)


@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_on_bfloat16_data_with_float32_statistics(training):
    g = (RS.rand(8) + 0.5).astype(np.float32)
    b = RS.randn(8).astype(np.float32)
    mean = np.full(8, 0.1, np.float32)
    var = np.full(8, 2.0, np.float32)
    kw = dict(eps=1e-5, fix_gamma=False, training=training)
    got = mx.nd.BatchNorm(_bf(X), *[mx.nd.array(a, ctx=CPU)
                                    for a in (g, b, mean, var)], **kw)
    want = jmx.nd.BatchNorm(_bf(X, True), *[jmx.nd.array(a)
                                            for a in (g, b, mean, var)],
                            **kw)
    _close(got[0], want[0])
    for s, js in zip(got[1:], want[1:]):
        assert _dtype_name(s) == _dtype_name(js) == "float32"
        np.testing.assert_allclose(_host(s), _host(js), rtol=1e-6,
                                   atol=1e-6)


def test_softmax_cross_entropy_on_bfloat16_predictions():
    pred = (RS.randn(8, 10) * 3).astype(np.float32)
    label = RS.randint(0, 10, 8).astype(np.float32)
    got = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
        _bf(pred), mx.nd.array(label, ctx=CPU))
    want = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(_bf(pred, True),
                                                    jmx.nd.array(label))
    _close(got, want)
    _close(got.mean(), want.mean())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("train_mode", [False, True])
def test_thumbnail_resnet18_forward_in_bfloat16(seed, train_mode):
    x = np.random.RandomState(seed).rand(8, 3, 32, 32).astype(np.float32)
    jmx.random.seed(seed)
    jnet = jvision.get_model("resnet18_v1", classes=10, thumbnail=True)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    net = vision.get_model("resnet18_v1", classes=10, thumbnail=True)
    net.initialize(ctx=CPU)
    load_jax_params(net, {n: p.data().asnumpy() for n, p in
                          jnet._collect_params_with_structure().items()})
    jnet.cast("bfloat16")
    net.cast("bfloat16")
    with jmx.autograd.pause(train_mode=train_mode):
        want = _host(jnet(_bf(x, True)))
    with mx.autograd.pause(train_mode=train_mode):
        got = _host(net(_bf(x)))
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= LOGIT_TOL * scale
    assert (got.argmax(1) == want.argmax(1)).all()
