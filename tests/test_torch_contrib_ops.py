"""The contrib ops (``ops/contrib_ops.py``) in the port against the JAX
package on the CPU: values and, through ``torch.autograd`` against
``jax.vjp``, gradients of every differentiable float input, from the same
seeded numpy inputs and cotangents.

Inputs with ties on purpose hold the sorts and the ``argmax`` picks: NMS
over duplicated boxes with equal scores, ``MultiBoxTarget`` with equally
confident negatives and duplicated ground truths, ``bipartite_matching``
over equal scores, ROI pooling where bins sample one pixel twice, and
sampling grids on pixel centres (where ``jnp.clip``'s gradient splits at
the tie).

Tolerances: float32 values at rtol 1e-5, atol 1e-5 (1e-4 for the FFT and
the products over 16 or more terms); gradients at rtol 1e-4, atol 1e-5.
Integer and mask outputs are held exactly.
"""
import ast
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx  # noqa: F401  (registers the JAX ops)
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as reg

VAL = dict(rtol=1e-5, atol=1e-5)
WIDE = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _rs(seed):
    return np.random.RandomState(seed)


def _f(seed, *shape, scale=1.0):
    return (_rs(seed).randn(*shape) * scale).astype(np.float32)


def _boxes(seed, *lead, lo=0.0, hi=1.0, min_size=0.05):
    rs = _rs(seed)
    xy = rs.uniform(lo, hi - 0.3, lead + (2,))
    wh = rs.uniform(min_size, 0.3, lead + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _anchors(h=4, w=5):
    x = np.zeros((1, 3, h, w), np.float32)
    return _port("MultiBoxPrior", [x], dict(sizes=(0.3, 0.5),
                                            ratios=(1.0, 2.0, 0.5)))[0][0]


def _nms_data(seed, b=2, n=16, with_ids=True):
    """Rows [id, score, x1, y1, x2, y2]: clusters of near-equal boxes, some
    exact duplicates, scores with ties (one decimal)."""
    rs = _rs(seed)
    base = _boxes(seed, b, 4)
    boxes = base[:, rs.randint(0, 4, n)] + rs.uniform(
        -0.03, 0.03, (b, n, 4)).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]                    # an exact duplicate
    scores = np.round(rs.uniform(0, 1, (b, n)), 1).astype(np.float32)
    scores[:, 1] = scores[:, 0]                  # ... with an equal score
    ids = rs.randint(0, 3 if with_ids else 1, (b, n)).astype(np.float32)
    ids[:, 1] = ids[:, 0]
    return np.concatenate([ids[..., None], scores[..., None], boxes], -1)


def _mbt_inputs(seed, b=3, m=4, classes=3):
    anchors = _anchors()
    n = anchors.shape[1]
    rs = _rs(seed)
    lab = np.full((b, m, 5), -1.0, np.float32)
    for i in range(b):
        k = i + 1
        lab[i, :k, 0] = rs.randint(0, classes, k)
        lab[i, :k, 1:] = _boxes(seed + i, k)
    lab[0, 1] = lab[0, 0]                        # a duplicated ground truth
    # confidences in steps of 0.25: many equal negatives
    pred = np.round(rs.uniform(0, 1, (b, classes + 1, n)) * 4) / 4
    return [anchors, lab, pred.astype(np.float32)]


def _det_inputs(seed, b=2, classes=3):
    anchors = _anchors()
    n = anchors.shape[1]
    rs = _rs(seed)
    logits = rs.randn(b, classes + 1, n) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = rs.randn(b, n * 4) * 0.2
    return [prob.astype(np.float32), loc.astype(np.float32), anchors]


def _rois(seed, r=5, b=2, h=8, w=9, scale=1.0):
    rs = _rs(seed)
    x1 = rs.uniform(-1, w - 3, r)
    y1 = rs.uniform(-1, h - 3, r)
    x2 = x1 + rs.uniform(0.5, 5, r)
    y2 = y1 + rs.uniform(0.5, 5, r)
    idx = rs.randint(0, b, r)
    return (np.stack([idx, x1, y1, x2, y2], 1) / [1, scale, scale, scale,
                                                  scale]).astype(np.float32)


def _center_grid(b=2, h=5, w=6):
    ys, xs = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                         indexing="ij")
    g = np.stack([xs, ys])[None].repeat(b, 0)
    return g.astype(np.float32)


def _image(seed, *shape):
    return _rs(seed).randint(0, 256, shape).astype(np.uint8)


# name, inputs, kwargs, indices of the inputs to differentiate, tolerance
CASES = [
    ("_contrib_fft", lambda: [_f(1, 3, 8)], {}, [0], WIDE),
    ("_contrib_ifft", lambda: [_f(2, 3, 16)], {}, [0], WIDE),
    ("MultiBoxPrior", lambda: [_f(3, 2, 3, 5, 6)],
     dict(sizes=(0.2, 0.35), ratios=(1.0, 2.0, 0.5)), [], VAL),
    ("MultiBoxPrior", lambda: [_f(3, 1, 3, 4, 3)],
     dict(sizes=(0.5, 0.9), ratios=(1.0, 3.0, 1 / 3), clip=True,
          steps=(0.2, 0.3), offsets=(0.25, 0.75)), [], VAL),
    ("_contrib_box_iou", lambda: [_boxes(4, 2, 5), _boxes(5, 2, 3)], {},
     [0, 1], VAL),
    ("_contrib_box_iou", lambda: [_boxes(4, 5), _boxes(5, 3)],
     dict(format="center"), [0, 1], VAL),
    ("box_nms", lambda: [_nms_data(6)],
     dict(overlap_thresh=0.5, valid_thresh=0.1, id_index=0), [0], VAL),
    ("box_nms", lambda: [_nms_data(7)],
     dict(overlap_thresh=0.3, topk=5, id_index=0, force_suppress=True),
     [0], VAL),
    ("box_nms", lambda: [_nms_data(8, with_ids=False)],
     dict(overlap_thresh=0.4, id_index=0, background_id=0), [0], VAL),
    ("_contrib_box_nms", lambda: [_nms_data(9)[0]],
     dict(overlap_thresh=0.5, in_format="center", out_format="corner"),
     [0], VAL),
    ("MultiBoxTarget", lambda: _mbt_inputs(10),
     dict(overlap_threshold=0.5, negative_mining_ratio=3.0,
          negative_mining_thresh=0.5), [], VAL),
    ("MultiBoxTarget", lambda: _mbt_inputs(11),
     dict(overlap_threshold=0.4, negative_mining_ratio=-1.0), [], VAL),
    ("MultiBoxTarget", lambda: _mbt_inputs(12),
     dict(negative_mining_ratio=1.5, minimum_negative_samples=5,
          ignore_label=-2.0, variances=(0.2, 0.2, 0.3, 0.3)), [], VAL),
    ("MultiBoxDetection", lambda: _det_inputs(13),
     dict(threshold=0.05, nms_threshold=0.45, nms_topk=10), [0, 1], VAL),
    ("MultiBoxDetection", lambda: _det_inputs(14),
     dict(clip=False, force_suppress=True, background_id=2), [0, 1], VAL),
    ("_contrib_box_encode",
     lambda: [(_rs(15).uniform(0, 1, (2, 6)) > 0.4).astype(np.float32),
              _rs(16).randint(-1, 3, (2, 6)).astype(np.float32),
              _boxes(17, 2, 6), _boxes(18, 2, 3)], {}, [2, 3], VAL),
    ("_contrib_box_encode",
     lambda: [np.ones((1, 4), np.float32),
              np.array([[0, 1, 1, 0]], np.float32),
              _boxes(19, 1, 4), _boxes(20, 1, 2)],
     dict(means=(0.1, 0.0, -0.1, 0.2), stds=(0.2, 0.2, 0.5, 0.5)),
     [2, 3], VAL),
    ("_contrib_box_decode", lambda: [_f(21, 2, 6, 4), _boxes(22, 1, 6)],
     {}, [0, 1], VAL),
    ("_contrib_box_decode", lambda: [_f(23, 2, 6, 4, scale=3),
                                     _boxes(24, 1, 6)],
     dict(clip=1.0, format="center", std0=0.2, std3=0.3), [0, 1], VAL),
    ("_contrib_bipartite_matching",
     lambda: [np.round(_rs(25).uniform(0, 1, (2, 5, 4)) * 4) / 4], {}, [],
     VAL),
    ("_contrib_bipartite_matching",
     lambda: [np.round(_rs(26).uniform(0, 1, (2, 3, 6)) * 4) / 4],
     dict(is_ascend=True, threshold=0.6, topk=2), [], VAL),
    ("ROIPooling", lambda: [_f(27, 2, 3, 8, 9), _rois(28)],
     dict(pooled_size=(3, 2)), [0], VAL),
    ("ROIPooling", lambda: [_f(29, 2, 3, 8, 9), _rois(30, scale=0.5)],
     dict(pooled_size=(2, 2), spatial_scale=0.5), [0], VAL),
    ("_contrib_ROIAlign", lambda: [_f(31, 2, 3, 8, 9), _rois(32)],
     dict(pooled_size=(3, 2)), [0, 1], VAL),
    ("_contrib_ROIAlign", lambda: [_f(33, 2, 3, 8, 9), _rois(34)],
     dict(pooled_size=(2, 3), sample_ratio=1, aligned=True,
          spatial_scale=0.9), [0, 1], VAL),
    ("GridGenerator", lambda: [_f(35, 2, 6)],
     dict(transform_type="affine", target_shape=(4, 5)), [0], VAL),
    ("GridGenerator", lambda: [_f(36, 2, 2, 4, 5)],
     dict(transform_type="warp"), [0], VAL),
    ("BilinearSampler", lambda: [_f(37, 2, 3, 6, 7),
                                 _rs(38).uniform(-1.3, 1.3, (2, 2, 4, 5))
                                 .astype(np.float32)], {}, [0, 1], VAL),
    ("BilinearSampler", lambda: [_f(39, 2, 3, 5, 6), _center_grid()], {},
     [0, 1], VAL),
    ("SpatialTransformer",
     lambda: [_f(40, 2, 3, 6, 7),
              (np.array([[0.9, 0.1, 0.05, -0.1, 1.1, 0.0]] * 2)
               + _f(41, 2, 6, scale=0.05)).astype(np.float32)],
     dict(target_shape=(4, 5)), [0, 1], VAL),
    ("_contrib_BilinearResize2D", lambda: [_f(42, 2, 3, 5, 6)],
     dict(height=9, width=11), [0], VAL),
    ("_contrib_BilinearResize2D", lambda: [_f(43, 2, 3, 12, 10)],
     dict(height=5, width=4), [0], VAL),
    ("_contrib_BilinearResize2D", lambda: [_f(44, 1, 2, 6, 8)],
     dict(scale_height=1.5, scale_width=0.5), [0], VAL),
    ("Correlation", lambda: [_f(45, 2, 3, 6, 7), _f(46, 2, 3, 6, 7)],
     dict(max_displacement=2), [0, 1], VAL),
    ("Correlation", lambda: [_f(47, 1, 4, 5, 5), _f(48, 1, 4, 5, 5)],
     dict(max_displacement=2, stride2=2, pad_size=1, is_multiply=False),
     [0, 1], VAL),
    ("_contrib_boolean_mask",
     lambda: [_f(49, 5, 3), np.array([1, 0, 1, 1, 0], np.float32)], {}, [],
     VAL),
    ("_contrib_boolean_mask",
     lambda: [_f(50, 2, 4), np.array([0, 1, 0, 1], np.float32)],
     dict(axis=1), [], VAL),
    ("_contrib_index_copy",
     lambda: [_f(51, 5, 3), np.array([0, 3], np.int32), _f(52, 2, 3)], {},
     [0, 2], VAL),
    ("_contrib_arange_like", lambda: [_f(53, 3, 4)],
     dict(start=1.5, step=0.5), [], VAL),
    ("_contrib_arange_like", lambda: [_f(53, 3, 6)],
     dict(axis=1, repeat=2, start=-1.0), [], VAL),
    ("multi_all_finite", lambda: [_f(54, 3), _f(55, 2, 2)],
     dict(num_arrays=2), [], VAL),
    ("multi_all_finite",
     lambda: [_f(54, 3), np.array([1.0, np.inf], np.float32)],
     dict(num_arrays=2), [], VAL),
    ("_contrib_count_sketch",
     lambda: [_f(56, 3, 8), _rs(57).randint(0, 5, (1, 8)).astype(np.float32),
              np.sign(_f(58, 1, 8))], dict(out_dim=5), [0], VAL),
    ("im2col", lambda: [_f(59, 2, 3, 6, 7)],
     dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2), pad=(1, 1)), [0],
     VAL),
    ("im2col", lambda: [_f(60, 2, 3, 9)], dict(kernel=(3,), pad=(2,)), [0],
     VAL),
    ("im2col", lambda: [_f(61, 1, 2, 4, 5, 4)],
     dict(kernel=(2, 2, 2), stride=(1, 2, 1)), [0], VAL),
    ("BlockGrad", lambda: [_f(62, 3, 4)], {}, [0], VAL),
    ("stop_gradient", lambda: [_f(62, 3, 4)], {}, [0], VAL),
    ("_contrib_interleaved_matmul_selfatt_qk", lambda: [_f(63, 5, 2, 24)],
     dict(heads=2), [0], WIDE),
    ("_contrib_interleaved_matmul_selfatt_valatt",
     lambda: [_f(64, 5, 2, 24), _f(65, 4, 5, 5)], dict(heads=2), [0, 1],
     WIDE),
    ("_contrib_interleaved_matmul_encdec_qk",
     lambda: [_f(66, 4, 2, 8), _f(67, 6, 2, 16)], dict(heads=2), [0, 1],
     WIDE),
    ("_contrib_interleaved_matmul_encdec_valatt",
     lambda: [_f(68, 6, 2, 16), _f(69, 4, 4, 6)], dict(heads=2), [0, 1],
     WIDE),
    ("_contrib_quadratic", lambda: [_f(70, 3, 4)], dict(a=0.5, b=-2.0, c=1.0),
     [0], VAL),
    ("quadratic", lambda: [_f(70, 3, 4)], dict(a=2.0), [0], VAL),
    ("_contrib_allclose", lambda: [_f(71, 3, 4), _f(71, 3, 4) + 1e-7], {},
     [], VAL),
    ("_contrib_allclose", lambda: [_f(71, 3, 4), _f(72, 3, 4)],
     dict(rtol=0.5, atol=0.5), [], VAL),
    ("_contrib_allclose",
     lambda: [np.array([np.nan, 1], np.float32),
              np.array([np.nan, 1], np.float32)], dict(equal_nan=True), [],
     VAL),
    ("_contrib_index_array", lambda: [_f(73, 2, 3, 4)], {}, [], VAL),
    ("_contrib_index_array", lambda: [_f(73, 2, 3, 4)], dict(axes=(2, 0)),
     [], VAL),
    ("_image_to_tensor", lambda: [_image(74, 5, 6, 3)], {}, [], VAL),
    ("_image_to_tensor", lambda: [_image(75, 2, 5, 6, 3)], {}, [], VAL),
    ("_image_normalize", lambda: [_f(76, 3, 5, 6)],
     dict(mean=(0.1, 0.2, 0.3), std=(0.5, 1.5, 2.0)), [0], VAL),
    ("_image_normalize", lambda: [_f(77, 2, 3, 4, 4)],
     dict(mean=(0.4,), std=(2.0,)), [0], VAL),
    ("_image_resize", lambda: [_image(78, 8, 10, 3)], dict(size=(5, 4)),
     [], VAL),
    ("_image_resize", lambda: [_image(79, 2, 5, 6, 3)], dict(size=9), [],
     VAL),
    ("_image_resize", lambda: [_f(80, 2, 5, 6, 3)],
     dict(size=(7, 3), interp=0), [], VAL),
    ("_image_resize", lambda: [_f(81, 6, 9, 2)], dict(size=(4, 4)), [], VAL),
    ("_image_crop", lambda: [_image(82, 8, 10, 3)],
     dict(x=2, y=1, width=4, height=5), [], VAL),
    ("_image_crop", lambda: [_f(83, 2, 8, 10, 3)],
     dict(x=3, y=2, width=5, height=3), [], VAL),
]


def _ids():
    return [f"{n}-{i}" for i, (n, *_rest) in enumerate(CASES)]


def _port(name, arrays, kw, diff=(), cots=None):
    ts = [torch.tensor(a, requires_grad=(i in diff))
          for i, a in enumerate(arrays)]
    out = reg.get(name)(*ts, **kw)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    grads = None
    if cots is not None:
        pairs = [(o, torch.tensor(c)) for o, c in zip(outs, cots)
                 if o.requires_grad]
        leaves = [ts[i] for i in diff]
        got = torch.autograd.grad([o for o, _ in pairs], leaves,
                                  [c for _, c in pairs],
                                  allow_unused=True) if pairs \
            else [None] * len(leaves)
        grads = [np.zeros_like(arrays[i]) if g is None else g.numpy()
                 for i, g in zip(diff, got)]
    return [o.detach().numpy() for o in outs], grads


def _jax(name, arrays, kw, diff=(), cots=None):
    fn = jreg.get(name).fn
    xs = [jnp.asarray(a) for a in arrays]

    def f(*d):
        full = list(xs)
        for i, v in zip(diff, d):
            full[i] = v
        return fn(*full, **kw)

    outs, pull = jax.vjp(f, *[xs[i] for i in diff])
    single = not isinstance(outs, (tuple, list))
    outs = [outs] if single else list(outs)
    grads = None
    if cots is not None:
        ct = [jnp.asarray(c).astype(o.dtype) for c, o in zip(cots, outs)]
        grads = [np.asarray(g) for g in pull(ct[0] if single else tuple(ct))]
    return [np.asarray(o) for o in outs], grads


@pytest.mark.parametrize("case", range(len(CASES)), ids=_ids())
def test_value_and_gradient_match_jax(case):
    name, make, kw, diff, tol = CASES[case]
    arrays = make()
    want, _ = _jax(name, arrays, kw)
    got, _ = _port(name, arrays, kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **tol)
    if not diff:
        return
    rs = _rs(100 + case)
    cots = [rs.randn(*w.shape).astype(np.float32) for w in want]
    _, jg = _jax(name, arrays, kw, diff, cots)
    _, pg = _port(name, arrays, kw, diff, cots)
    for g, w in zip(pg, jg):
        np.testing.assert_allclose(g, w, **GRAD)


def test_the_contrib_ops_are_registered_with_the_jax_names_and_flags():
    """Every name of the JAX ``contrib_ops.py`` but ``_contrib_getnnz``
    (sparse arrays, ROADMAP A4), with its aliases, output count and
    differentiability."""
    import mxnet_tpu.ops.contrib_ops as jc

    names = {n for n in jreg.list_ops()
             if jreg.get(n).fn.__module__ == jc.__name__
             or n in ("BatchNorm_v1", "_contrib_SyncBatchNorm")}
    assert len(names) == 38, sorted(names)
    for name in sorted(names - {"_contrib_getnnz"}):
        jop = jreg.get(name)
        assert reg.canonical(name) == name
        assert set(reg.aliases(name)) == set(jop.aliases), name
        assert reg.differentiable(name) == jop.differentiable, name
        n_out = jop.num_outputs if isinstance(jop.num_outputs, int) else 1
        assert reg.num_outputs(name) == max(n_out, 1), name
    with pytest.raises(MXNetError, match="not ported"):
        reg.get("_contrib_getnnz")


def test_nms_keeps_the_first_of_equal_boxes_in_input_order():
    """Two identical boxes of equal score: the stable sort keeps the one
    that comes first in the input and suppresses the other, in both
    packages, in either order of the rows."""
    row = [0, 0.9, 0.1, 0.1, 0.5, 0.5]
    other = [0, 0.3, 0.6, 0.6, 0.9, 0.9]
    data = np.array([[row, other, row]], np.float32)
    kw = dict(overlap_thresh=0.5, id_index=0)
    got, _ = _port("box_nms", [data], kw)
    want, _ = _jax("box_nms", [data], kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0][0, 2], -np.ones(6))
    np.testing.assert_array_equal(got[0][0, :2], data[0, :2])


def test_hard_negatives_among_equal_confidences_follow_anchor_order():
    """All anchors equally confident: the stable rank keeps the
    lowest-indexed eligible anchors as negatives, as the JAX op does."""
    anchors, lab, _ = _mbt_inputs(90)
    pred = np.full((3, 4, anchors.shape[1]), 0.5, np.float32)
    kw = dict(negative_mining_ratio=2.0)
    got, _ = _port("MultiBoxTarget", [anchors, lab, pred], kw)
    want, _ = _jax("MultiBoxTarget", [anchors, lab, pred], kw)
    np.testing.assert_allclose(got[0], want[0], **VAL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    cls = got[2][0]
    neg = np.flatnonzero(cls == 0)
    ignored = np.flatnonzero(cls == -1)
    assert len(neg) and len(ignored) and neg.max() < ignored.max()


def test_c25_box_nms_writes_center_boxes_unlike_the_jax_package():
    """``out_format="center"`` from corner input: the port writes center
    boxes (MXNet 1.x); the JAX op raises, its second
    ``_corner_to_center`` returning a tuple (fault C25)."""
    data = _nms_data(91)[:1]
    kw = dict(overlap_thresh=0.5, id_index=0, out_format="center")
    got, _ = _port("box_nms", [data], kw)
    corner, _ = _port("box_nms", [data], dict(kw, out_format="corner"))
    kept = corner[0][0, :, 0] >= 0
    c = corner[0][0, kept, 2:]
    centre = np.stack([(c[:, 0] + c[:, 2]) / 2, (c[:, 1] + c[:, 3]) / 2,
                       c[:, 2] - c[:, 0], c[:, 3] - c[:, 1]], -1)
    np.testing.assert_allclose(got[0][0, kept, 2:], centre, **VAL)
    with pytest.raises(Exception):
        _jax("box_nms", [data], kw)


def _bn_inputs(seed):
    rs = _rs(seed)
    return [_f(seed, 4, 3, 5, 5), rs.uniform(0.5, 1.5, 3).astype(np.float32),
            _f(seed + 1, 3), _f(seed + 2, 3, scale=0.1),
            rs.uniform(0.5, 1.5, 3).astype(np.float32)]


@pytest.mark.parametrize("name", ["BatchNorm_v1", "_contrib_SyncBatchNorm",
                                  "SyncBatchNorm"])
@pytest.mark.parametrize("kw", [dict(training=True, fix_gamma=False),
                                dict(training=False, eps=1e-5),
                                dict(training=True, fix_gamma=True,
                                     momentum=0.8)])
def test_batchnorm_variants_match_jax(name, kw):
    arrays = _bn_inputs(92)
    want, _ = _jax(name, arrays, kw)
    got, _ = _port(name, arrays, kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    rs = _rs(93)
    cots = [rs.randn(*w.shape).astype(np.float32) for w in want[:1]] + \
        [np.zeros_like(w) for w in want[1:]]
    _, jg = _jax(name, arrays, kw, [0, 1, 2], cots)
    _, pg = _port(name, arrays, kw, [0, 1, 2], cots)
    for g, w in zip(pg, jg):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_c26_sync_batchnorm_over_two_cards_raises_unlike_the_jax_package():
    """``ndev=2``: the JAX op normalises over the local batch; the port
    raises, naming the second card a cross-card reduction needs (fault
    C26)."""
    arrays = _bn_inputs(94)
    want, _ = _jax("_contrib_SyncBatchNorm", arrays, dict(ndev=2))
    assert np.isfinite(want[0]).all()
    with pytest.raises(MXNetError, match=r"second card \(gpu\(1\)\)"):
        _port("_contrib_SyncBatchNorm", arrays, dict(ndev=2))
    got, _ = _port("_contrib_SyncBatchNorm", arrays, dict(ndev=1))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_nd_and_sym_contrib_hold_every_jax_contrib_name():
    """``mx.nd.contrib`` and ``mx.sym.contrib`` hold every name that the
    JAX package's hold, the ops reached only through a ``_contrib_`` alias
    (``MultiBoxPrior``, ``box_nms``) among them. ``getnnz`` and the DGL
    functions raise, naming the sparse arrays they wait for. The JAX
    ``quantization.py`` ops that the port has not ported yet (ROADMAP item
    A5) are left out of the comparison."""
    import mxnet_tpu.ops.quantization as jq

    later = {n[len("_contrib_"):] for n in jreg.list_ops()
             if jreg.get(n).fn.__module__ == jq.__name__
             and n not in reg._REGISTRY}
    jnd = {n for n in dir(jmx.nd.contrib) if not n.startswith("_")} - later
    jsym = {n for n in dir(jmx.sym.contrib) if not n.startswith("_")} - later
    waiting = {"getnnz", "dgl_csr_neighbor_uniform_sample",
               "dgl_csr_neighbor_non_uniform_sample", "dgl_subgraph",
               "edge_id", "dgl_adjacency", "dgl_graph_compact"}
    pnd = set(dir(mx.nd.contrib))
    psym = set(dir(mx.sym.contrib))
    assert not (jnd - pnd), sorted(jnd - pnd)
    assert not (jsym - psym), sorted(jsym - psym)
    for name in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                 "box_nms", "SyncBatchNorm", "fft", "ROIAlign"):
        assert callable(getattr(mx.nd.contrib, name))
        assert callable(getattr(mx.sym.contrib, name))
    for name in sorted(waiting):
        with pytest.raises(MXNetError, match="sparse"):
            getattr(mx.nd.contrib, name)()
    with pytest.raises(MXNetError, match="sparse"):
        mx.sym.contrib.getnnz()


def _node_attrs(js):
    return {n["name"]: {k: ast.literal_eval(v) for k, v in
                        (n.get("attrs") or {}).items()}
            for n in json.loads(js)["nodes"]}


def test_sym_contrib_tuple_attributes_round_trip_with_the_jax_json():
    """The tuple attributes of the detection ops (``sizes``, ``ratios``,
    ``steps``, ``variances``, ``pooled_size``) read the same from the
    port's JSON and the JAX package's, both ways."""
    def build(m):
        data = m.sym.var("data")
        anchors = m.sym.contrib.MultiBoxPrior(
            data, sizes=(0.1, 0.141), ratios=(1, 2, 0.5), steps=(0.1, 0.2),
            name="anchors")
        det = m.sym.contrib.MultiBoxDetection(
            m.sym.var("cls_prob"), m.sym.var("loc_pred"), anchors,
            variances=(0.1, 0.1, 0.2, 0.2), nms_topk=5, name="det")
        pool = m.sym.ROIPooling(data, m.sym.var("rois"), pooled_size=(3, 2),
                                spatial_scale=0.5, name="pool")
        return m.sym.Group([det, pool])

    want = {"anchors": {"sizes": (0.1, 0.141), "ratios": (1, 2, 0.5),
                        "steps": (0.1, 0.2)},
            "det": {"variances": (0.1, 0.1, 0.2, 0.2), "nms_topk": 5},
            "pool": {"pooled_size": (3, 2), "spatial_scale": 0.5}}
    for js in (build(mx).tojson(), build(jmx).tojson()):
        for loaded in (mx.sym.load_json(js), jmx.sym.load_json(js)):
            attrs = _node_attrs(loaded.tojson())
            for node, kv in want.items():
                for k, v in kv.items():
                    assert tuple(np.atleast_1d(attrs[node][k])) == \
                        tuple(np.atleast_1d(v)), (node, k, attrs[node][k])


def test_nd_contrib_ops_run_on_ndarrays():
    """The ``nd.contrib`` wrappers take NDArrays and keyword
    hyper-parameters, as the JAX package's do."""
    with mx.cpu():
        x = mx.nd.array(_f(95, 1, 3, 4, 4))
        a = mx.nd.contrib.MultiBoxPrior(x, sizes=(0.5,), ratios=(1.0, 2.0))
        assert a.shape == (1, 32, 4)
        iou = mx.nd.contrib.box_iou(a[0], a[0])
        assert iou.shape == (32, 32)
        np.testing.assert_allclose(np.diag(iou.asnumpy()), 1.0, rtol=1e-6)
        y = mx.nd.BlockGrad(x) + mx.nd.stop_gradient(x)
        assert y.shape == x.shape
