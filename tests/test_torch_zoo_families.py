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


def _e_dbl(name):
    """Whether structural ``name`` lies in the third branch (the double
    3x3) of an Inception v3 block E: fault C20, MXNet 1.x's branch in the
    port (a 1x1 to 448 and a 3x3 to 384 before the split), the split
    reading the block's input in the JAX package; a name of a block E
    alone starts at its branch. Parity tests that carry JAX weights into
    Inception skip that branch."""
    parts = name.split(".")
    return parts[0] == "branch2" or parts[:3] in (
        ["features", "16", "branch2"], ["features", "17", "branch2"])


@pytest.mark.parametrize("name", NEW)
def test_constructor_names_shapes_and_count_match_jax(name, fresh_names):
    net = vision.get_model(name, classes=7)
    jnet = jvision.get_model(name, classes=7)
    if name == "inception_v3":
        # C20: the two E blocks' third branches differ, and the new
        # convolutions renumber the prefixed names after them; the rest
        # is held by structural name (the counts: test_c20_*)
        got, want = ({k: tuple(p.shape) for k, p in
                      n._collect_params_with_structure().items()
                      if not _e_dbl(k)} for n in (net, jnet))
    else:
        got = {k: tuple(p.shape) for k, p in net.collect_params().items()}
        want = {k: tuple(p.shape) for k, p in jnet.collect_params().items()}
    assert list(got) == list(want)
    assert got == want


def _trainable(net, x):
    net.initialize()
    net(x)
    return sum(int(np.prod(p.shape)) for p in net.collect_params().values()
               if p.grad_req != "null")


def test_c20_inception_v3_counts_mxnets_parameters_unlike_the_jax_package():
    x = np.zeros((1, 3, 299, 299), np.float32)
    with mx.cpu():
        got = _trainable(vision.inception_v3(), mx.nd.array(x))
    assert got == 23834568           # MXNet 1.x's Inception v3
    assert _trainable(jvision.inception_v3(), jmx.nd.array(x)) == 25141960


@pytest.mark.parametrize("alias,name", [
    ("inceptionv3", "inception_v3"), ("mobilenet1.0", "mobilenet1_0"),
    ("mobilenet0.75", "mobilenet0_75"), ("mobilenet0.5", "mobilenet0_5"),
    ("mobilenet0.25", "mobilenet0_25"),
    ("mobilenetv2_1.0", "mobilenet_v2_1_0"),
    ("mobilenetv2_0.75", "mobilenet_v2_0_75"),
    ("mobilenetv2_0.5", "mobilenet_v2_0_5"),
    ("mobilenetv2_0.25", "mobilenet_v2_0_25"),
    ("squeezenet1.0", "squeezenet1_0"), ("squeezenet1.1", "squeezenet1_1"),
    ("ResNet50_V1", "resnet50_v1")])
def test_c21_get_model_takes_mxnets_names_and_the_jax_ones(alias, name,
                                                          fresh_names):
    by_alias = vision.get_model(alias, classes=5)
    with mx.name.NameManager():
        by_name = vision.get_model(name, classes=5)
    assert type(by_alias) is type(by_name)
    assert [tuple(p.shape) for p in by_alias.collect_params().values()] == \
        [tuple(p.shape) for p in by_name.collect_params().values()]
    if alias.lower() != name:
        # MXNet's spelling: an alias only, and the JAX registry refuses it
        assert alias not in vision.get_model_names()
        with pytest.raises(ValueError):
            jvision.get_model(alias, classes=5)


def _carry(make, x, skip=lambda name: False):
    """The block from both packages with the JAX weights in the port's
    (but those whose structural name ``skip`` holds: the port keeps its
    own there)."""
    with mx.name.NameManager():
        block = make(vision)
    jblock = make(jvision)
    jblock.initialize(jmx.init.Xavier())
    jout = jblock(jmx.nd.array(x)).asnumpy()
    block.initialize(ctx=CPU)
    block(mx.nd.array(x, ctx=CPU))
    weights = {n: p.data().asnumpy()
               for n, p in jblock._collect_params_with_structure().items()
               if not skip(n)}
    weights.update((n, p.data().asnumpy()) for n, p in
                   block._collect_params_with_structure().items() if skip(n))
    load_jax_params(block, weights)
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
    block, _, jout = _carry(_inception_block(kind), x,
                            skip=_e_dbl if kind == "E" else lambda n: False)
    got = block(mx.nd.array(x, ctx=CPU)).asnumpy()
    assert got.shape == jout.shape
    if kind == "E":
        # C20: the third branch (channels 1088-1855 of 320 + 768 + 768 +
        # 192) is MXNet 1.x's in the port; the other three are held
        keep = np.r_[0:1088, 1856:2048]
        got, jout = got[:, keep], jout[:, keep]
    np.testing.assert_allclose(got, jout, **TOL)


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
