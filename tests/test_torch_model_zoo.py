"""The port's vision model zoo and the layers it is built from, on the
CPU against the JAX package's: parameter names and shapes of ResNet v1
and v2, the resnet50_v1 forward at batch 2 and 64x64 in eval and train
mode from the same weights (``convert.load_jax_params``), the running
statistics a train-mode forward writes, and the layers' own behaviour
(deferred ``in_channels``, pooling layers, BatchNorm, Flatten,
Activation, what is not ported)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.convert import export_params, load_jax_params
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision

CPU = mx.cpu()
# eval mode: float32 forward, different summation orders (the JAX
# package's XLA convolutions against oneDNN's), relative to the largest
# logit
EVAL_TOL = 1e-5
# train mode: BatchNorm normalises with the batch's statistics, which at
# the last stage of a 64x64 input are 8 values a channel (batch 2, 2x2):
# a small standard deviation divides the rounding differences, so the
# logits and running statistics agree to 1e-3 of their largest magnitude
TRAIN_TOL = 1e-3


def _close(got, want, tol, what=""):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _jax_net(name, x, **kw):
    net = jvision.get_model(name, **kw)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(x))   # resolve deferred shapes
    return net


def _weights(jnet):
    return {n: p.data().asnumpy()
            for n, p in jnet._collect_params_with_structure().items()}


@pytest.fixture
def fresh_names(monkeypatch):
    """Both packages number unprefixed top-level blocks (``resnetv10_``)
    from per-thread counters, which other tests in the same process
    advance: start both from zero."""
    from mxnet_tpu_torch.gluon.block import _BlockScope

    monkeypatch.setattr(_BlockScope._tls, "top", {}, raising=False)
    with jmx.name.NameManager():
        yield


def _params_equal_jax(name, **kw):
    x = np.zeros((1, 3, 32, 32), np.float32)
    jnet = _jax_net(name, x, classes=10, **kw)
    net = vision.get_model(name, classes=10, **kw)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    net(mx.nd.array(x, ctx=CPU))
    want = jnet.collect_params()
    got = net.collect_params()
    assert list(got.keys()) == list(want.keys())
    for k in want.keys():
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].grad_req == want[k].grad_req, k
    struct = net._collect_params_with_structure()
    assert list(struct) == list(jnet._collect_params_with_structure())
    assert sum(k.endswith(("running_mean", "running_var")) for k in struct) \
        == sum(k.endswith(("running_mean", "running_var"))
               for k in jnet._collect_params_with_structure())
    return list(got.keys())


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v1",
                                  "resnet50_v2"])
def test_collect_params_names_and_shapes_equal_jax(name, fresh_names):
    """Default prefixes, made from the class name and the counter."""
    keys = _params_equal_jax(name)
    assert keys[0].startswith(f"resnetv{name[-1]}0_"), keys[0]


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet50_v1",
                                  "resnet50_v2"])
def test_collect_params_names_and_shapes_equal_jax_with_a_prefix(name):
    keys = _params_equal_jax(name, prefix="net_")
    assert keys[0].startswith("net_"), keys[0]


@pytest.fixture(scope="module")
def resnet50_pair():
    x = np.random.RandomState(0).rand(2, 3, 64, 64).astype(np.float32)
    jnet = _jax_net("resnet50_v1", x, classes=1000)
    net = vision.resnet50_v1(classes=1000)
    net.initialize(ctx=CPU)
    assert load_jax_params(net, _weights(jnet)) == 161 + 32 + 106
    return x, jnet, net


def test_resnet50_v1_eval_forward_matches_jax(resnet50_pair):
    x, jnet, net = resnet50_pair
    want = jnet(jmx.nd.array(x)).asnumpy()
    got = net(mx.nd.array(x, ctx=CPU)).asnumpy()
    assert got.shape == (2, 1000)
    _close(got, want, EVAL_TOL)


def test_resnet50_v1_train_forward_and_running_stats_match_jax(
        resnet50_pair):
    x, jnet, net = resnet50_pair
    before = export_params(net)
    with jmx.autograd.record():
        want = jnet(jmx.nd.array(x)).asnumpy()
    with mx.autograd.record():
        got = net(mx.nd.array(x, ctx=CPU)).asnumpy()
    _close(got, want, TRAIN_TOL)
    after, jafter = export_params(net), _weights(jnet)
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 106
    for k in stats:
        assert not np.array_equal(after[k], before[k]), k
        _close(after[k], jafter[k], TRAIN_TOL, k)
    for k in after:
        if k not in stats:
            assert np.array_equal(after[k], before[k]), k


def test_conv_layers_defer_in_channels_and_pool():
    net = nn.HybridSequential()
    net.add(nn.Conv2D(6, 3, padding=1, use_bias=False),
            nn.MaxPool2D(3, 2, 1), nn.AvgPool2D(2, ceil_mode=True),
            nn.GlobalAvgPool2D(), nn.Flatten())
    net.initialize(ctx=CPU)
    out = net(mx.nd.array(np.ones((2, 5, 9, 9), np.float32), ctx=CPU))
    assert out.shape == (2, 6)
    assert net[0].weight.shape == (6, 5, 3, 3) and net[0].bias is None
    c1 = nn.Conv1D(3, 2, strides=2, activation="relu")
    c3 = nn.Conv3D(2, (1, 2, 2), groups=1)
    for block, shape, want in ((c1, (1, 4, 8), (1, 3, 4)),
                               (c3, (1, 2, 3, 4, 4), (1, 2, 3, 3, 3))):
        block.initialize(ctx=CPU)
        y = block(mx.nd.array(np.random.RandomState(0).randn(*shape)
                              .astype(np.float32), ctx=CPU))
        assert y.shape == want
    assert (c1(mx.nd.array(-np.ones((1, 4, 8), np.float32), ctx=CPU))
            .asnumpy() >= 0).all()


@pytest.mark.parametrize("name,args,kwargs,shape,want", [
    ("MaxPool1D", (2,), {}, (1, 2, 6), (1, 2, 3)),
    ("AvgPool1D", (3, 1, 1), {"count_include_pad": False}, (1, 2, 6),
     (1, 2, 6)),
    ("MaxPool3D", (2,), {}, (1, 1, 4, 4, 4), (1, 1, 2, 2, 2)),
    ("AvgPool3D", (2,), {"ceil_mode": True}, (1, 1, 5, 5, 5),
     (1, 1, 3, 3, 3)),
    ("GlobalMaxPool1D", (), {}, (2, 3, 5), (2, 3, 1)),
    ("GlobalMaxPool2D", (), {}, (2, 3, 5, 4), (2, 3, 1, 1)),
    ("GlobalMaxPool3D", (), {}, (2, 3, 2, 5, 4), (2, 3, 1, 1, 1)),
    ("GlobalAvgPool1D", (), {}, (2, 3, 5), (2, 3, 1)),
    ("GlobalAvgPool3D", (), {}, (2, 3, 2, 5, 4), (2, 3, 1, 1, 1)),
])
def test_pooling_layers_match_jax(name, args, kwargs, shape, want):
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    got = getattr(nn, name)(*args, **kwargs)(mx.nd.array(x, ctx=CPU))
    assert got.shape == want
    ref = getattr(jmx.gluon.nn, name)(*args, **kwargs)(jmx.nd.array(x))
    _close(got.asnumpy(), ref.asnumpy(), EVAL_TOL)


def test_batchnorm_layer_updates_running_stats_in_train_mode_only():
    x = np.random.RandomState(1).randn(6, 3, 4, 4).astype(np.float32) * 2 + 1
    bn = nn.BatchNorm()
    bn.initialize(ctx=CPU)
    with mx.autograd.pause(train_mode=False):
        y_eval = bn(mx.nd.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(y_eval, x / np.sqrt(1 + 1e-5), rtol=1e-6)
    assert bn.running_mean.data().asnumpy().tolist() == [0.0] * 3
    with mx.autograd.record():
        y = bn(mx.nd.array(x, ctx=CPU))
    mean = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3))   # biased, as the JAX layer's
    np.testing.assert_allclose(bn.running_mean.data().asnumpy(), 0.1 * mean,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.data().asnumpy(),
                               0.9 + 0.1 * var, rtol=1e-5)
    assert not bn.running_mean.data()._data.requires_grad
    np.testing.assert_allclose(
        y.asnumpy(), (x - mean[:, None, None]) /
        np.sqrt(var[:, None, None] + 1e-5), rtol=1e-4, atol=1e-5)
    frozen = nn.BatchNorm(use_global_stats=True)
    frozen.initialize(ctx=CPU)
    with mx.autograd.record():
        frozen(mx.nd.array(x, ctx=CPU))
    assert frozen.running_var.data().asnumpy().tolist() == [1.0] * 3


def test_flatten_and_activation_layers():
    x = mx.nd.array(np.arange(-6, 6, dtype=np.float32).reshape(2, 3, 2),
                    ctx=CPU)
    assert nn.Flatten()(x).shape == (2, 6)
    act = nn.Activation("relu")
    assert act.prefix.startswith("relu")
    assert (act(x).asnumpy() == np.maximum(x.asnumpy(), 0)).all()
    np.testing.assert_allclose(nn.Activation("sigmoid")(x).asnumpy(),
                               1 / (1 + np.exp(-x.asnumpy())), rtol=1e-6)


def test_what_is_not_ported_raises():
    for ctor in (lambda: nn.Conv2DTranspose(4, 3), lambda: nn.Conv1DTranspose(
            4, 3), lambda: nn.Conv3DTranspose(4, 3),
            lambda: nn.ReflectionPad2D(1)):
        with pytest.raises(mx.MXNetError, match="not ported"):
            ctor()
    for name in ("vgg16", "mobilenet_v2_1_0", "densenet121", "alexnet",
                 "squeezenet1_0", "inception_v3"):
        with pytest.raises(mx.MXNetError, match="ROADMAP"):
            vision.get_model(name)
    with pytest.raises(ValueError, match="not supported"):
        vision.get_model("resnet51_v1")
    with pytest.raises(mx.MXNetError, match="download"):
        vision.get_model("resnet18_v1", pretrained=True)
    with pytest.raises(mx.MXNetError, match="layout"):
        nn.Conv2D(4, 3, layout="NHWC")


@pytest.mark.parametrize("version,depth", [(1, 18), (1, 34), (1, 50),
                                           (1, 101), (1, 152), (2, 18),
                                           (2, 34), (2, 50), (2, 101),
                                           (2, 152)])
def test_every_resnet_depth_builds_with_the_jax_parameter_count(
        version, depth, fresh_names):
    name = f"resnet{depth}_v{version}"
    for kw in ({}, {"prefix": "net_"}):   # default and given prefixes
        net = vision.get_model(name, classes=7, thumbnail=True, **kw)
        jnet = jvision.get_model(name, classes=7, thumbnail=True, **kw)
        assert list(net.collect_params().keys()) == \
            list(jnet.collect_params().keys())
    assert vision.get_model_names().count(name) == 1
