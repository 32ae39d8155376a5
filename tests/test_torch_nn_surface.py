"""The sixteen ``ops/nn.py`` ops this slice ports and every mode of
``LeakyReLU``, on the CPU against the JAX package: forward, and the
gradient under ``autograd.record()`` / ``backward()`` with a random head
gradient against ``jax.vjp`` of the JAX op; symbol support (parameter
inputs, ``infer_shape``, graph JSON both ways); and the JAX package's
faults that the port departs from, each asserted in both packages:
C15 (grouped Deconvolution raises in JAX), C16 (CTC padding with the
blank first), C17 (MakeLoss / make_loss's backward) and C18
(Deconvolution's ``target_shape``).

Tolerances: float32, rtol 1e-5 and atol 1e-6 (the same expressions in
different orders), except where stated: the transposed convolution
(atol 1e-5: a different summation order over the kernel), LRN's
``pow`` (rtol 1e-5), CTC (rtol 1e-5 on losses around 10-20, and 1e-5
on gradients: the recursion runs the same ops in the same order).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as preg
from test_torch_ops_math import check

CPU = mx.cpu()


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ------------------------------------------------------------ LeakyReLU --

@pytest.mark.parametrize("act", ["leaky", "elu", "selu", "gelu", "rrelu"])
def test_leaky_relu_modes_match_jax(act):
    x = _rand(4, 3, 5, seed=1) * 2
    check("LeakyReLU", [x], dict(act_type=act, slope=0.3), argnums=(0,))


def test_prelu_learned_slope_and_its_gradient_match_jax():
    x, g = _rand(2, 3, 4, 4, seed=2), np.array([0.1, 0.25, -0.2],
                                               np.float32)
    check("LeakyReLU", [x, g], dict(act_type="prelu"), argnums=(0, 1))
    check("LeakyReLU", [x, np.array([0.3], np.float32)],
          dict(act_type="prelu"), argnums=(0, 1))


def test_rrelu_in_training_draws_slopes_from_the_generator():
    """Training with a generator: each negative element times a slope in
    [lower, upper); the same generator seed gives the same slopes; the
    midpoint otherwise (the JAX op without a key)."""
    x = -np.abs(_rand(200, 50, seed=3)) - 0.1
    t = torch.from_numpy(x)
    op = preg.get("LeakyReLU")
    gen = torch.Generator().manual_seed(5)
    a = op(t, act_type="rrelu", training=True, generator=gen)
    slopes = (a / t).numpy()
    assert slopes.min() >= 0.125 and slopes.max() < 0.334
    assert abs(slopes.mean() - (0.125 + 0.334) / 2) < 0.01
    b = op(t, act_type="rrelu", training=True,
           generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    mid = op(t, act_type="rrelu", training=True)
    np.testing.assert_allclose(mid.numpy(), np.asarray(jreg.get(
        "LeakyReLU").fn(jnp.asarray(x), act_type="rrelu", training=True)),
        rtol=1e-6)


# ---------------------------------------------------------------- norms --

def test_group_instance_and_l2_normalization_match_jax():
    x = _rand(2, 6, 5, 4, seed=4) * 3 + 1
    g, b = _rand(6, seed=5), _rand(6, seed=6)
    for groups in (1, 2, 6):
        check("GroupNorm", [x, g, b], dict(num_groups=groups, eps=1e-5),
              argnums=(0, 1, 2), atol=1e-5)
    check("InstanceNorm", [x, g, b], dict(eps=1e-3), argnums=(0, 1, 2),
          atol=1e-5)
    for mode in ("instance", "channel", "spatial"):
        check("L2Normalization", [x], dict(mode=mode), argnums=(0,))


def test_lrn_softmin_softmax_activation_and_smooth_l1_match_jax():
    x = np.abs(_rand(2, 7, 3, 3, seed=7)) + 0.1
    check("LRN", [x], dict(alpha=1e-2, beta=0.75, knorm=2.0, nsize=5),
          argnums=(0,))
    check("LRN", [x], dict(nsize=3), argnums=(0,))
    y = _rand(3, 4, 5, seed=8)
    for axis in (-1, 1):
        check("softmin", [y], dict(axis=axis), argnums=(0,))
    for mode in ("instance", "channel"):
        check("SoftmaxActivation", [y], dict(mode=mode), argnums=(0,))
    for scalar in (1.0, 2.0):
        check("smooth_l1", [y * 2], dict(scalar=scalar), argnums=(0,))
    check("relu6", [y * 5], {}, argnums=(0,))


def test_upsampling_and_crop_match_jax():
    a, b = _rand(2, 3, 4, 4, seed=9), _rand(2, 2, 2, 2, seed=10)
    check("UpSampling", [a], dict(scale=2, sample_type="nearest"),
          argnums=(0,))
    for mode in ("concat", "sum"):
        c = b if mode == "concat" else _rand(2, 3, 2, 2, seed=11)
        check("UpSampling", [a, c], dict(scale=2, num_args=2,
                                         multi_input_mode=mode),
              argnums=(0, 1))
    w = _rand(3, 1, 4, 4, seed=12)
    check("UpSampling", [a, w], dict(scale=2, sample_type="bilinear",
                                     num_filter=3), argnums=(0,))
    x = _rand(2, 3, 7, 6, seed=13)
    check("Crop", [x], dict(h_w=(3, 4), offset=(1, 2)), argnums=(0,))
    check("Crop", [x, a], dict(num_args=2, center_crop=True), argnums=(0,))


def test_batch_norm_with_relu_and_sparse_embedding_match_jax():
    x = _rand(4, 3, 2, 2, seed=14)
    g, b = _rand(3, seed=15), _rand(3, seed=16)
    mm, mv = _rand(3, seed=17), np.abs(_rand(3, seed=18)) + 0.5
    head = _rand(4, 3, 2, 2, seed=20)
    for training in (True, False):
        kw = dict(fix_gamma=False, training=training)
        # every output forward; the gradient of the normalised output
        check("_contrib_BatchNormWithReLU", [x, g, b, mm, mv], kw)
        _, vjp = jax.vjp(lambda *a: jreg.get(
            "_contrib_BatchNormWithReLU").fn(*a, mm, mv, **kw)[0],
            *(jnp.asarray(t) for t in (x, g, b)))
        want = vjp(jnp.asarray(head))
        ts = [torch.from_numpy(t).requires_grad_() for t in (x, g, b)]
        out = preg.get("_contrib_BatchNormWithReLU")(
            *ts, torch.from_numpy(mm), torch.from_numpy(mv), **kw)[0]
        out.backward(torch.from_numpy(head))
        for t, w in zip(ts, want):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)
    ids = np.array([[0, 3], [5, 1]], np.float32)
    w = _rand(6, 4, seed=19)
    check("_contrib_SparseEmbedding", [ids, w],
          dict(input_dim=6, output_dim=4), argnums=(1,))


# -------------------------------------------------------- Deconvolution --

DECONV = [
    # (data shape, weight shape, kwargs)
    ((2, 3, 5, 5), (3, 4, 3, 3), dict(kernel=(3, 3), num_filter=4)),
    ((2, 3, 5, 6), (3, 2, 4, 4), dict(kernel=(4, 4), stride=(2, 2),
                                      pad=(1, 1), num_filter=2)),
    ((1, 2, 4, 4), (2, 3, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1), adj=(1, 1),
                                      dilate=(2, 2), num_filter=3)),
    ((2, 3, 7), (3, 5, 3), dict(kernel=(3,), stride=(2,), num_filter=5)),
    ((1, 2, 3, 3, 3), (2, 2, 2, 2, 2), dict(kernel=(2, 2, 2),
                                            stride=(2, 2, 2),
                                            num_filter=2)),
]


@pytest.mark.parametrize("case", range(len(DECONV)))
def test_deconvolution_matches_jax(case):
    dshape, wshape, kw = DECONV[case]
    x, w = _rand(*dshape, seed=20), _rand(*wshape, seed=21)
    b = _rand(kw["num_filter"], seed=22)
    check("Deconvolution", [x, w], dict(kw, no_bias=True), argnums=(0, 1),
          atol=1e-5)
    check("Deconvolution", [x, w, b], dict(kw, no_bias=False),
          argnums=(0, 1, 2), atol=1e-5)


def test_grouped_deconvolution_is_mxnets_c15():
    """Fault C15: the JAX op raises for ``num_group > 1``; the port
    computes MXNet's grouped deconvolution, which equals the JAX op run on
    each group's channels and concatenated."""
    x, w = _rand(2, 4, 5, 5, seed=23), _rand(4, 3, 3, 3, seed=24)
    kw = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1),
              num_filter=6, num_group=2, no_bias=True)
    with pytest.raises(Exception, match="4 // 2 != 4|feature_group_count"):
        jreg.get("Deconvolution").fn(jnp.asarray(x), jnp.asarray(w), **kw)
    got = preg.get("Deconvolution")(torch.from_numpy(x),
                                    torch.from_numpy(w), **kw).numpy()
    one = dict(kw, num_group=1, num_filter=3)
    want = np.concatenate([np.asarray(jreg.get("Deconvolution").fn(
        jnp.asarray(x[:, 2 * i:2 * i + 2]), jnp.asarray(w[2 * i:2 * i + 2]),
        **one)) for i in range(2)], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_deconvolution_target_shape_is_mxnets_c18():
    """Fault C18: MXNet derives ``pad`` and ``adj`` from ``target_shape``
    (``deconvolution-inl.h``); the JAX op ignores it. A target of 10x9
    from a 5x5 input at stride 2, kernel 4: the full output is 12x12, so
    pad (1, 2) and adj (0, 1), and the result is the JAX op with those."""
    x, w = _rand(1, 2, 5, 5, seed=25), _rand(2, 3, 4, 4, seed=26)
    kw = dict(kernel=(4, 4), stride=(2, 2), num_filter=3, no_bias=True)
    got = preg.get("Deconvolution")(torch.from_numpy(x), torch.from_numpy(w),
                                    target_shape=(10, 9), **kw).numpy()
    assert got.shape == (1, 3, 10, 9)
    jax_ignores = np.asarray(jreg.get("Deconvolution").fn(
        jnp.asarray(x), jnp.asarray(w), target_shape=(10, 9), **kw))
    assert jax_ignores.shape == (1, 3, 12, 12)
    want = np.asarray(jreg.get("Deconvolution").fn(
        jnp.asarray(x), jnp.asarray(w), pad=(1, 2), adj=(0, 1), **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- CTC ----

def _ctc_case(seed=30):
    rs = np.random.RandomState(seed)
    data = rs.randn(12, 3, 6).astype(np.float32)
    label = np.array([[1, 2, 3, 0], [2, 2, 0, 0], [4, 1, 5, 3]], np.float32)
    return data, label


def test_ctc_loss_with_the_blank_last_matches_jax():
    data, label = _ctc_case()
    lab = label - 1
    lab[lab < 0] = -1          # -1 pads, labels 0..4, blank 5
    check("CTCLoss", [data, lab], dict(blank_label="last"), argnums=(0,),
          rtol=1e-5, atol=1e-5)
    lens = np.array([10, 12, 8], np.float32)
    llen = np.array([3, 2, 4], np.float32)
    check("CTCLoss", [data, lab, lens, llen],
          dict(blank_label="last", use_data_lengths=True,
               use_label_lengths=True), argnums=(0,), rtol=1e-5, atol=1e-5)


def test_ctc_padding_with_the_blank_first_is_mxnets_c16():
    """Fault C16: with ``blank_label="first"`` MXNet pads labels with 0;
    the JAX op counts every label >= 0, so ``[1, 2, 0, 0]`` is a label of
    length 4 there and its loss differs from ``[1, 2, -1, -1]``'s. The
    port reads 0 as padding: both spellings give the JAX value of the
    -1-padded one."""
    rs = np.random.RandomState(0)
    data = rs.randn(10, 1, 5).astype(np.float32)
    zero = np.array([[1, 2, 0, 0]], np.float32)
    minus = np.array([[1, 2, -1, -1]], np.float32)
    fn = jreg.get("CTCLoss").fn
    j_zero = float(np.asarray(fn(jnp.asarray(data), jnp.asarray(zero)))[0])
    j_minus = float(np.asarray(fn(jnp.asarray(data),
                                  jnp.asarray(minus)))[0])
    assert abs(j_zero - j_minus) > 1.0
    op = preg.get("CTCLoss")
    p_zero = float(op(torch.from_numpy(data), torch.from_numpy(zero))[0])
    np.testing.assert_allclose(p_zero, j_minus, rtol=1e-5)
    # the gradient too: the port on 0-padded labels, JAX on -1-padded
    data, label = _ctc_case()
    head = np.random.RandomState(1).randn(3).astype(np.float32)
    loss, vjp = jax.vjp(lambda d: fn(d, jnp.asarray(np.where(
        label == 0, -1, label))), jnp.asarray(data))
    t = torch.from_numpy(data).requires_grad_()
    got = op(t, torch.from_numpy(label))
    got.backward(torch.from_numpy(head))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(loss),
                               rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(head))[0]),
                               rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------- MakeLoss ----

@pytest.mark.parametrize("norm", ["null", "batch", "valid"])
def test_make_loss_backward_is_mxnets_c17(norm):
    """Fault C17: MXNet's MakeLoss writes ``grad_scale`` (over the batch
    or the count of values above ``valid_thresh``) whatever the head
    gradient, and make_loss ones; the JAX ops are the identity, so their
    gradient is the head gradient."""
    x = _rand(4, 3, seed=40)
    head = _rand(4, 3, seed=41)
    kw = dict(grad_scale=2.0, valid_thresh=0.1, normalization=norm)
    _, vjp = jax.vjp(lambda a: jreg.get("MakeLoss").fn(a, **kw),
                     jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(vjp(jnp.asarray(head))[0]), head)
    with CPU:
        a = mx.nd.array(x)
        a.attach_grad()
        with mx.autograd.record():
            out = mx.nd.MakeLoss(a, **kw)
        out.backward(mx.nd.array(head))
    np.testing.assert_array_equal(out.asnumpy(), x)
    div = {"null": 1.0, "batch": 4.0,
           "valid": float(max((x > 0.1).sum(), 1))}[norm]
    np.testing.assert_allclose(a.grad.asnumpy(), np.full_like(x, 2.0 / div),
                               rtol=1e-6)
    with CPU:
        b = mx.nd.array(x)
        b.attach_grad()
        with mx.autograd.record():
            mx.nd.make_loss(b).backward(mx.nd.array(head))
    np.testing.assert_array_equal(b.grad.asnumpy(), np.ones_like(x))


# --------------------------------------------------- registry and symbol --

def test_every_name_of_the_jax_nn_module_is_registered():
    from pathlib import Path

    src = Path(jmx.__file__).parent / "ops" / "nn.py"
    names = []

    def register(name, aliases=(), **kw):
        names.extend((name,) + tuple(aliases))
        return lambda fn: type("Op", (), {"fn": staticmethod(fn)})

    code = src.read_text().replace("from .registry import register", "")
    code = code.replace("_register_sparse_embedding()\n",
                        "names.append('_contrib_SparseEmbedding')\n")
    exec(compile(code, str(src), "exec"),
         {"register": register, "names": names, "__name__": "probe"})
    assert len(set(names)) >= 29
    missing = sorted(set(names) - set(preg._REGISTRY))
    assert not missing, missing


def _graph(pkg):
    data = pkg.sym.var("data")
    d = pkg.sym.Deconvolution(data, kernel=(4, 4), stride=(2, 2),
                              pad=(1, 1), num_filter=4, no_bias=False,
                              name="up")
    n = pkg.sym.GroupNorm(d, num_groups=2, name="gn")
    a = pkg.sym.LeakyReLU(n, act_type="prelu", name="act")
    i = pkg.sym.InstanceNorm(a, name="inorm")
    return pkg.sym.relu6(pkg.sym.LRN(i, nsize=3, name="lrn"), name="r6")


def test_new_layer_ops_compose_infer_shapes_and_cross_as_json():
    port, jsym = _graph(mx), _graph(jmx)
    assert port.list_arguments() == jsym.list_arguments()
    shapes = port.infer_shape(data=(2, 3, 5, 5))
    assert shapes == tuple([tuple(s) for s in x]
                           for x in jsym.infer_shape(data=(2, 3, 5, 5)))
    rs = np.random.RandomState(0)
    vals = {name: rs.randn(*shape).astype(np.float32)
            for name, shape in zip(port.list_arguments(), shapes[0])}
    want = jsym.eval_with({k: jmx.nd.array(v)
                           for k, v in vals.items()}).asnumpy()
    for sym in (port, mx.sym.load_json(jsym.tojson())):
        got = sym.eval_with({k: mx.nd.array(v, ctx=CPU)
                             for k, v in vals.items()}).asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = jmx.sym.load_json(port.tojson())
    np.testing.assert_allclose(back.eval_with(
        {k: jmx.nd.array(v) for k, v in vals.items()}).asnumpy(), want,
        rtol=1e-5, atol=1e-5)
    assert [n["op"] for n in json.loads(port.tojson())["nodes"]
            if n["op"] != "null"] == ["Deconvolution", "GroupNorm",
                                      "LeakyReLU", "InstanceNorm", "LRN",
                                      "relu6"]
