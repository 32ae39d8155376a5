"""The gluon layers and losses this slice ports, on the CPU against the
JAX package from the same weights and inputs: the norm layers, the
activation layers (PReLU's learned slope and its initializer included),
Lambda and HybridLambda (traced into a graph), the transposed
convolutions with ``groups``, ``output_padding`` and ``dilation``,
ReflectionPad2D, and the ten losses with ``weight`` and
``sample_weight``; and fault C19 (the JAX transposed convolutions drop
their bias).

Tolerances: float32, outputs and gradients at rtol 1e-5 and atol 1e-5
(the same expressions; convolutions sum in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import nn

CPU = mx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(make, x):
    """The layer from both packages, the JAX weights carried into the
    port's; returns both blocks."""
    with mx.name.NameManager():
        block = make(nn)
    jblock = make(jmx.gluon.nn)
    jblock.initialize(jmx.init.Xavier())
    jblock(jmx.nd.array(x))
    block.initialize(ctx=CPU)
    block(mx.nd.array(x, ctx=CPU))
    weights = {n: p.data().asnumpy()
               for n, p in jblock._collect_params_with_structure().items()}
    if weights:
        load_jax_params(block, weights)
    return block, jblock


def _forward_backward(block, jblock, x):
    """Outputs and the input and parameter gradients of a random head, in
    both packages."""
    head = _rand(*np.asarray(jblock(jmx.nd.array(x)).asnumpy()).shape,
                 seed=99)
    xs = mx.nd.array(x, ctx=CPU)
    xs.attach_grad()
    with mx.autograd.record():
        out = block(xs)
    out.backward(mx.nd.array(head, ctx=CPU))
    jx = jmx.nd.array(x)
    jx.attach_grad()
    with jmx.autograd.record():
        jout = jblock(jx)
    jout.backward(jmx.nd.array(head))
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), **TOL)
    np.testing.assert_allclose(xs.grad.asnumpy(), jx.grad.asnumpy(), **TOL)
    jp = jblock._collect_params_with_structure()
    for n, p in block._collect_params_with_structure().items():
        if p.grad_req != "null":
            np.testing.assert_allclose(p.grad().asnumpy(),
                                       jp[n].grad().asnumpy(), err_msg=n,
                                       **TOL)
    return out


LAYERS = {
    "InstanceNorm": lambda m: m.InstanceNorm(scale=True),
    "GroupNorm": lambda m: m.GroupNorm(num_groups=2),
    "LeakyReLU": lambda m: m.LeakyReLU(0.2),
    "PReLU": lambda m: m.PReLU(),
    "PReLU_channels": lambda m: m.PReLU(in_channels=4),
    "ELU": lambda m: m.ELU(0.7),
    "SELU": lambda m: m.SELU(),
    "Swish": lambda m: m.Swish(1.5),
    "GELU": lambda m: m.GELU(),
    "HybridLambda": lambda m: m.HybridLambda(
        lambda F, x: F.invoke("clip", x, a_min=-0.5, a_max=0.5)),
    "HybridLambda_name": lambda m: m.HybridLambda("tanh"),
    "ReflectionPad2D": lambda m: m.ReflectionPad2D(2),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_gradients_match_jax(name):
    x = _rand(2, 4, 5, 6, seed=1)
    block, jblock = _pair(LAYERS[name], x)
    _forward_backward(block, jblock, x)


def test_prelu_slope_starts_at_its_initializer_and_learns():
    with mx.name.NameManager():
        prelu = nn.PReLU(in_channels=3)
    prelu.initialize(ctx=CPU)
    np.testing.assert_array_equal(prelu.alpha.data().asnumpy(),
                                  np.full(3, 0.25, np.float32))
    trainer = mx.gluon.Trainer(prelu.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    x = mx.nd.array(-np.abs(_rand(2, 3, 4, seed=2)), ctx=CPU)
    with mx.autograd.record():
        loss = prelu(x).sum()
    loss.backward()
    trainer.step(1)
    # d(sum(alpha * x))/d alpha = sum of x per channel (all negative)
    want = 0.25 - 0.1 * x.asnumpy().sum(axis=(0, 2))
    np.testing.assert_allclose(prelu.alpha.data().asnumpy(), want,
                               rtol=1e-6)


def test_lambda_of_a_name_and_of_a_function():
    x = mx.nd.array(_rand(3, 4, seed=3), ctx=CPU)
    np.testing.assert_allclose(nn.Lambda("tanh")(x).asnumpy(),
                               np.tanh(x.asnumpy()), rtol=1e-6)
    np.testing.assert_array_equal(
        nn.Lambda(lambda a: a * 2)(x).asnumpy(), x.asnumpy() * 2)


TRANSPOSED = [
    ("Conv1DTranspose", (2, 4, 7), dict(channels=6, kernel_size=3,
                                        strides=2, padding=1,
                                        output_padding=1, groups=2)),
    ("Conv2DTranspose", (2, 4, 5, 5), dict(channels=3, kernel_size=4,
                                           strides=2, padding=1,
                                           use_bias=False)),
    ("Conv2DTranspose", (2, 4, 5, 6), dict(channels=4, kernel_size=3,
                                           strides=2, padding=1,
                                           output_padding=1, dilation=2,
                                           groups=4, use_bias=False)),
    ("Conv3DTranspose", (1, 2, 3, 3, 3), dict(channels=2, kernel_size=2,
                                              strides=2, use_bias=False)),
]


@pytest.mark.parametrize("case", range(len(TRANSPOSED)))
def test_transposed_convolutions_match_jax(case):
    """Without bias against the JAX layer; grouped ones (which the JAX op
    refuses, C15) against the JAX op per group, concatenated."""
    name, shape, kw = TRANSPOSED[case]
    x = _rand(*shape, seed=4)
    groups = kw.get("groups", 1)
    if groups == 1:
        block, jblock = _pair(lambda m: getattr(m, name)(**kw), x)
        _forward_backward(block, jblock, x)
        return
    with mx.name.NameManager():
        block = getattr(nn, name)(**kw)
    block.initialize(mx.init.Xavier(), ctx=CPU)
    out = block(mx.nd.array(x, ctx=CPU)).asnumpy()
    w = block.weight.data().asnumpy()
    assert w.shape[:2] == (shape[1], kw["channels"] // groups)
    n = len(shape) - 2
    op_kw = dict(kernel=(kw["kernel_size"],) * n,
                 stride=(kw.get("strides", 1),) * n,
                 pad=(kw.get("padding", 0),) * n,
                 adj=(kw.get("output_padding", 0),) * n,
                 dilate=(kw.get("dilation", 1),) * n,
                 num_filter=kw["channels"] // groups, no_bias=True)
    cin = shape[1] // groups
    want = np.concatenate([np.asarray(jreg.get("Deconvolution").fn(
        jnp.asarray(x[:, g * cin:(g + 1) * cin]),
        jnp.asarray(w[g * cin:(g + 1) * cin]), **op_kw))
        for g in range(groups)], axis=1)
    if block.bias is not None:
        want = want + block.bias.data().asnumpy().reshape(
            (1, -1) + (1,) * n)
    np.testing.assert_allclose(out, want, **TOL)


def test_transposed_convolution_bias_is_mxnets_c19():
    """Fault C19: MXNet's transposed-convolution layers pass ``no_bias =
    not use_bias``; the JAX layer passes nothing and its op's ``no_bias``
    defaults to True, so its bias never reaches the output. The port adds
    it: the port's output is the JAX output plus the bias."""
    x = _rand(2, 3, 4, 4, seed=5)
    block, jblock = _pair(lambda m: m.Conv2DTranspose(
        5, 3, strides=2, bias_initializer="ones"), x)
    bias = np.arange(5, dtype=np.float32) + 1.0
    block.bias.set_data(mx.nd.array(bias, ctx=CPU))
    jblock.bias.set_data(jmx.nd.array(bias))
    got = block(mx.nd.array(x, ctx=CPU)).asnumpy()
    want = jblock(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got - bias.reshape(1, 5, 1, 1), want, **TOL)


def test_transposed_convolution_traces_and_reloads():
    x = _rand(1, 3, 4, 4, seed=6)
    with mx.name.NameManager():
        block = nn.HybridSequential(prefix="g_")
        with block.name_scope():
            block.add(nn.Conv2DTranspose(4, 4, 2, 1, use_bias=False),
                      nn.BatchNorm(), nn.LeakyReLU(0.2),
                      nn.Conv2DTranspose(2, 3, 1, 1, groups=2))
    block.initialize(mx.init.Xavier(), ctx=CPU)
    want = block(mx.nd.array(x, ctx=CPU)).asnumpy()
    sym = block._trace_symbol()
    args = {n: p.data() for n, p in block.collect_params().items()}
    got = mx.sym.load_json(sym.tojson()).eval_with(
        dict(args, data=mx.nd.array(x, ctx=CPU))).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)


# --------------------------------------------------------------- losses --

def _losses(pkg):
    L = pkg.gluon.loss
    return {
        "L1Loss": (L.L1Loss(weight=0.5), "reg"),
        "SigmoidBCE": (L.SigmoidBinaryCrossEntropyLoss(), "bin"),
        "SigmoidBCE_from_sigmoid": (
            L.SigmoidBinaryCrossEntropyLoss(from_sigmoid=True), "prob"),
        "KLDivLoss": (L.KLDivLoss(), "dist"),
        "KLDivLoss_logits": (L.KLDivLoss(from_logits=False), "dist"),
        "HuberLoss": (L.HuberLoss(rho=0.7), "reg"),
        "HingeLoss": (L.HingeLoss(margin=0.8), "sign"),
        "SquaredHingeLoss": (L.SquaredHingeLoss(), "sign"),
        "LogisticLoss": (L.LogisticLoss(), "sign"),
        "LogisticLoss_binary": (L.LogisticLoss(label_format="binary"),
                                "bin"),
    }


def _label(kind, shape, rs):
    if kind == "reg":
        return rs.randn(*shape).astype(np.float32)
    if kind == "bin":
        return (rs.rand(*shape) > 0.5).astype(np.float32)
    if kind == "sign":
        return np.where(rs.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)
    if kind == "dist":
        p = rs.rand(*shape).astype(np.float32) + 0.1
        return p / p.sum(-1, keepdims=True)
    return rs.rand(*shape).astype(np.float32)


def _run_loss(loss, pkg, ctx, args):
    arrays = [pkg.nd.array(a, ctx=ctx) if ctx else pkg.nd.array(a)
              for a in args]
    arrays[0].attach_grad()
    with pkg.autograd.record():
        out = loss(*arrays)
    out.backward()
    return out.asnumpy(), arrays[0].grad.asnumpy()


@pytest.mark.parametrize("name", sorted(_losses(jmx)))
@pytest.mark.parametrize("weighted", [False, True])
def test_loss_and_its_gradient_match_jax(name, weighted):
    rs = np.random.RandomState(len(name))
    loss, kind = _losses(mx)[name]
    jloss, _ = _losses(jmx)[name]
    pred = rs.randn(4, 5).astype(np.float32)
    if kind == "prob":
        pred = 1 / (1 + np.exp(-pred))
    if name == "KLDivLoss":
        pred = np.log(_label("dist", (4, 5), rs))
    args = [pred, _label(kind, (4, 5), rs)]
    if weighted:
        args.append(rs.rand(4, 1).astype(np.float32))
    got = _run_loss(loss, mx, CPU, args)
    want = _run_loss(jloss, jmx, None, args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_sigmoid_bce_pos_weight_triplet_and_cosine_match_jax():
    rs = np.random.RandomState(0)
    pred, lab = rs.randn(4, 5).astype(np.float32), (rs.rand(4, 5) > 0.5
                                                    ).astype(np.float32)
    pw = rs.rand(1, 5).astype(np.float32) + 0.5
    sw = rs.rand(4, 1).astype(np.float32)
    for from_sigmoid, p in ((False, pred), (True, 1 / (1 + np.exp(-pred)))):
        got = mx.gluon.loss.SigmoidBCELoss(from_sigmoid=from_sigmoid)(
            *(mx.nd.array(a, ctx=CPU) for a in (p, lab, sw, pw)))
        want = jmx.gluon.loss.SigmoidBCELoss(from_sigmoid=from_sigmoid)(
            *(jmx.nd.array(a) for a in (p, lab, sw, pw)))
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    a, b, c = (rs.randn(4, 3, 2).astype(np.float32) for _ in range(3))
    for weighted in (False, True):
        extra = [rs.rand(4).astype(np.float32)] if weighted else []
        got = _run_loss(mx.gluon.loss.TripletLoss(margin=0.5), mx, CPU,
                        [a, b, c] + extra)
        want = _run_loss(jmx.gluon.loss.TripletLoss(margin=0.5), jmx, None,
                         [a, b, c] + extra)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
    x1, x2 = rs.randn(6, 4).astype(np.float32), rs.randn(6, 4).astype(
        np.float32)
    y = np.array([1, -1, 1, -1, 1, -1], np.float32)
    for weighted in (False, True):
        extra = [rs.rand(6).astype(np.float32)] if weighted else []
        got = _run_loss(mx.gluon.loss.CosineEmbeddingLoss(margin=0.1), mx,
                        CPU, [x1, x2, y] + extra)
        want = _run_loss(jmx.gluon.loss.CosineEmbeddingLoss(margin=0.1),
                         jmx, None, [x1, x2, y] + extra)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"),
                                                 ("TNC", "TN")])
def test_ctc_loss_layer_matches_jax(layout, label_layout):
    rs = np.random.RandomState(3)
    pred = rs.randn(3, 10, 6).astype(np.float32)          # N T C
    label = np.array([[0, 1, 2, -1], [3, 3, -1, -1], [4, 0, 1, 2]],
                     np.float32)
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    sw = rs.rand(3).astype(np.float32)
    for weight in (None, sw):
        results = []
        for pkg, ctx in ((mx, CPU), (jmx, None)):
            arr = (lambda a: pkg.nd.array(a, ctx=ctx)) if ctx else \
                pkg.nd.array
            xs = arr(pred)
            xs.attach_grad()
            with pkg.autograd.record():
                out = pkg.gluon.loss.CTCLoss(layout, label_layout)(
                    xs, arr(label), None, None,
                    None if weight is None else arr(weight))
            out.backward()
            results.append((out.asnumpy(), xs.grad.asnumpy()))
        for g, w in zip(*results):
            np.testing.assert_allclose(g, w, **TOL)


def test_gluon_loss_and_nn_have_every_class_of_the_jax_package():
    assert sorted(mx.gluon.loss.__all__) == sorted(jmx.gluon.loss.__all__)
    assert sorted(nn.__all__) == sorted(jmx.gluon.nn.__all__)
    assert nn.SymbolBlock is mx.gluon.SymbolBlock
