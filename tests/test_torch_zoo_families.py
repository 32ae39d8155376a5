"""The six model-zoo families this slice ports (AlexNet, DenseNet,
Inception v3, MobileNet v1/v2, SqueezeNet, VGG) on the CPU against the
JAX package.

* Every constructor: the same parameter names, declared shapes and count
  as the JAX model (before a forward, with the same deferred entries).
* One model per family, forward with the JAX weights carried in, at the
  smallest input the family takes: AlexNet at 64, VGG 11 at 32,
  SqueezeNet 1.1 at 64 (its ``ceil_mode`` pools), MobileNet v1 and v2 at
  0.25 width and 32. DenseNet ends in a 7x7 average pool and Inception
  v3 in an 8x8 one, so they need 224 and 299, whose eager JAX forwards
  on the CPU take 10-25 s: their blocks are held one by one at small
  sizes (a dense layer, a transition, Inception's A-E blocks).
* MobileNet v2's exported graph: ``tests/test_torch_mobilenet_export.py``.

Tolerances: float32 forwards at rtol 1e-4, atol 1e-5 (deep stacks of
convolutions, summed in other orders; the largest error met is 4e-6).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision

CPU = mx.cpu()
TOL = dict(rtol=1e-4, atol=1e-5)
NEW = [n for n in jvision.get_model_names() if not n.startswith("resnet")]


@pytest.fixture
def fresh_names(monkeypatch):
    from mxnet_tpu_torch.gluon.block import _BlockScope

    monkeypatch.setattr(_BlockScope._tls, "top", {}, raising=False)
    with jmx.name.NameManager():
        yield


def test_the_registry_is_the_jax_registry():
    assert vision.get_model_names() == jvision.get_model_names()
    assert len(NEW) == 24
    with pytest.raises(mx.MXNetError, match="download"):
        vision.get_model("squeezenet1_1", pretrained=True)


@pytest.mark.parametrize("name", NEW)
def test_constructor_names_shapes_and_count_match_jax(name, fresh_names):
    net = vision.get_model(name, classes=7)
    jnet = jvision.get_model(name, classes=7)
    got = {k: tuple(p.shape) for k, p in net.collect_params().items()}
    want = {k: tuple(p.shape) for k, p in jnet.collect_params().items()}
    assert list(got) == list(want)
    assert got == want


def _carry(make, x):
    """The block from both packages with the JAX weights in the port's."""
    with mx.name.NameManager():
        block = make(vision)
    jblock = make(jvision)
    jblock.initialize(jmx.init.Xavier())
    jout = jblock(jmx.nd.array(x)).asnumpy()
    block.initialize(ctx=CPU)
    block(mx.nd.array(x, ctx=CPU))
    load_jax_params(block, {
        n: p.data().asnumpy()
        for n, p in jblock._collect_params_with_structure().items()})
    return block, jblock, jout


FAMILIES = {
    "alexnet": (lambda v: v.alexnet(classes=10), 64),
    "vgg11": (lambda v: v.vgg11(classes=10), 32),
    "squeezenet1_1": (lambda v: v.squeezenet1_1(classes=10), 64),
    "mobilenet0_25": (lambda v: v.mobilenet0_25(classes=10), 32),
    "mobilenet_v2_0_25": (lambda v: v.mobilenet_v2_0_25(classes=10), 32),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_forward_matches_jax_with_its_weights(name):
    make, size = FAMILIES[name]
    x = np.random.RandomState(0).randn(2, 3, size, size).astype(np.float32)
    block, _, jout = _carry(make, x)
    got = block(mx.nd.array(x, ctx=CPU)).asnumpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, jout, **TOL)


def _inception_block(kind):
    def make(v):
        from importlib import import_module

        mod = import_module(v.__name__ + ".inception")
        return {"A": lambda: mod._make_A(8, "A_"),
                "B": lambda: mod._make_B("B_"),
                "C": lambda: mod._make_C(16, "C_"),
                "D": lambda: mod._make_D("D_"),
                "E": lambda: mod._make_E("E_")}[kind]()
    return make


@pytest.mark.parametrize("kind", ["A", "B", "C", "D", "E"])
def test_inception_blocks_match_jax(kind):
    x = np.random.RandomState(1).randn(1, 16, 9, 9).astype(np.float32)
    block, _, jout = _carry(_inception_block(kind), x)
    np.testing.assert_allclose(block(mx.nd.array(x, ctx=CPU)).asnumpy(),
                               jout, **TOL)


def test_densenet_layer_and_transition_match_jax():
    def make(v):
        from importlib import import_module

        mod = import_module(v.__name__ + ".densenet")
        nn = mod.nn
        seq = nn.HybridSequential(prefix="d_")
        with seq.name_scope():
            seq.add(mod._DenseLayer(8, 2, 0), mod._DenseLayer(8, 2, 0))
            trans = nn.HybridSequential(prefix="")
            mod._bn_relu_conv(trans, 16, kernel=1)
            trans.add(nn.AvgPool2D(pool_size=2, strides=2))
            seq.add(trans)
        return seq

    x = np.random.RandomState(2).randn(2, 4, 8, 8).astype(np.float32)
    block, _, jout = _carry(make, x)
    np.testing.assert_allclose(block(mx.nd.array(x, ctx=CPU)).asnumpy(),
                               jout, **TOL)
