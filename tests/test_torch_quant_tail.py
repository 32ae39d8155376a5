"""The quantized op tail of the port (``mxnet_tpu_torch/ops/
quantization.py``: requantize, the int8 activation, flatten, concat,
elementwise add and multiply, pooling and BatchNorm, the affine
quantize and the entropy calibration) against the JAX ops on the same
numpy inputs, on the CPU. The JAX ops run eagerly, op by op, as
``tests/test_quantization.py`` runs them.

Tolerance: none. Integer outputs and ranges are equal bit for bit
(``np.array_equal``), and so are the float32 outputs that come from the
same float32 operations in the same order (scales, shifts, thresholds);
the entropy threshold is compared on histograms whose 64 candidates have
one clear minimum."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as reg


def _jax(op, *arrays, **kw):
    out = jreg.get(op).fn(*(jnp.asarray(a) for a in arrays), **kw)
    return [np.asarray(o) for o in out] if isinstance(out, (tuple, list)) \
        else [np.asarray(out)]


def _port(op, *arrays, **kw):
    out = reg.get(op)(*(torch.from_numpy(np.array(a)) for a in arrays),
                      **kw)
    return [o.numpy() for o in out] if isinstance(out, (tuple, list)) \
        else [out.numpy()]


def _equal(op, *arrays, **kw):
    got, want = _port(op, *arrays, **kw), _jax(op, *arrays, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                          a.shape, b.shape)
        np.testing.assert_array_equal(a, b)
    return got


def _codes(shape, seed):
    return np.random.RandomState(seed).randint(-127, 128, shape).astype(
        np.int8)


def _f32(v):
    return np.float32(v)


RANGES = [(-1.5, 2.0), (0.25, 3.0), (-4.0, -0.5), (0.0, 0.0)]


@pytest.mark.parametrize("shape", [(4, 5), (2, 3, 8)])
@pytest.mark.parametrize("calib", [None, (-0.75, 1.25)])
def test_requantize(shape, calib):
    rs = np.random.RandomState(1)
    acc = rs.randint(-2 ** 30, 2 ** 30, shape).astype(np.int32)
    kw = {} if calib is None else {"min_calib_range": calib[0],
                                   "max_calib_range": calib[1]}
    q, lo, hi = _equal("_contrib_requantize", acc, _f32(-7.5), _f32(6.0),
                       **kw)
    assert q.dtype == np.int8 and lo.dtype == hi.dtype == np.float32


@pytest.mark.parametrize("rng", RANGES)
@pytest.mark.parametrize("act_type", ["relu", "sigmoid"])
def test_quantized_act(rng, act_type):
    _equal("_contrib_quantized_act", _codes((3, 4, 5), 2), _f32(rng[0]),
           _f32(rng[1]), act_type=act_type)


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (6, 7)])
def test_quantized_flatten(shape):
    q, _, _ = _equal("_contrib_quantized_flatten", _codes(shape, 3),
                     _f32(-1.0), _f32(2.0))
    assert q.shape == (shape[0], int(np.prod(shape[1:])))


@pytest.mark.parametrize("n,dim", [(2, 1), (3, 1), (3, 0), (2, 2)])
def test_quantized_concat(n, dim):
    datas = [_codes((2, 3, 4), 10 + i) for i in range(n)]
    ranges = []
    for i in range(n):
        lo, hi = RANGES[i % len(RANGES)]
        ranges += [_f32(lo * (i + 1)), _f32(hi + i)]
    _equal("_contrib_quantized_concat", *datas, *ranges, dim=dim,
           num_args=n)


@pytest.mark.parametrize("op", ["_contrib_quantized_elemwise_add",
                                "_contrib_quantized_elemwise_mul"])
@pytest.mark.parametrize("ranges", [((-1.0, 2.0), (-3.0, 0.5)),
                                    ((0.0, 4.0), (-0.125, 0.25)),
                                    ((0.0, 0.0), (-1.0, 1.0))])
def test_quantized_elemwise(op, ranges):
    (ll, lh), (rl, rh) = ranges
    _equal(op, _codes((4, 6), 4), _codes((4, 6), 5), _f32(ll), _f32(lh),
           _f32(rl), _f32(rh))


POOL_CASES = [
    dict(kernel=(2, 2), stride=(2, 2), pool_type="max"),
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    dict(kernel=(2, 2), stride=(2, 2), pool_type="avg"),
    dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type="avg"),
    dict(kernel=(3, 3), stride=(2, 2), pool_type="avg",
         pooling_convention="full"),
    dict(global_pool=True, pool_type="max"),
    dict(global_pool=True, pool_type="avg"),
    dict(kernel=(3,), stride=(2,), pad=(1,), pool_type="max"),
]


@pytest.mark.parametrize("kw", POOL_CASES)
def test_quantized_pooling(kw):
    shape = (2, 3, 9) if len(kw.get("kernel", (0, 0))) == 1 else \
        (2, 3, 7, 9)
    _equal("_contrib_quantized_pooling", _codes(shape, 6), _f32(-2.0),
           _f32(2.5), **kw)


@pytest.mark.parametrize("calib", [None, (-3.0, 4.0)])
@pytest.mark.parametrize("shape", [(2, 4, 3, 3), (5, 4)])
def test_quantized_batch_norm(calib, shape):
    rs = np.random.RandomState(7)
    c = shape[1]
    gamma = (rs.rand(c) + 0.5).astype(np.float32)
    beta = rs.randn(c).astype(np.float32)
    mean = (0.1 * rs.randn(c)).astype(np.float32)
    var = (rs.rand(c) + 0.2).astype(np.float32)
    kw = {} if calib is None else {"min_calib_range": calib[0],
                                   "max_calib_range": calib[1]}
    _equal("_contrib_quantized_batch_norm", _codes(shape, 8), gamma, beta,
           mean, var, _f32(-1.5), _f32(1.75), eps=1e-3, **kw)


@pytest.mark.parametrize("calib", [None, (-1.0, 3.0), (2.0, 2.0)])
@pytest.mark.parametrize("shape", [(3, 5), (2, 3, 4)])
def test_quantize_asym(calib, shape):
    x = (np.random.RandomState(9).randn(*shape) * 1.5 + 0.3).astype(
        np.float32)
    kw = {} if calib is None else {"min_calib_range": calib[0],
                                   "max_calib_range": calib[1]}
    _equal("_contrib_quantize_asym", x, **kw)


def _histogram(seed, bins, tail):
    rs = np.random.RandomState(seed)
    x = np.concatenate([rs.randn(20000), tail * rs.standard_cauchy(200)])
    th = float(np.abs(x).max())
    hist, edges = np.histogram(x, bins=bins, range=(-th, th))
    return hist.astype(np.float32), edges.astype(np.float32)


def _kls(hist, edges, nq):
    """The JAX op's 64 KL scores, recomputed in float64 (numpy), to pick
    histograms whose minimum is clear."""
    centers = (edges[:-1].astype(np.float64) + edges[1:]) / 2
    abs_max = max(abs(float(edges[0])), abs(float(edges[-1])))
    out = []
    for t in np.linspace(abs_max / 64, abs_max, 64):
        inside = np.abs(centers) <= t
        p = np.where(inside, hist, 0.0)
        p = p + np.where(inside, (hist.sum() - p.sum()) / max(inside.sum(),
                                                              1), 0.0)
        b = np.clip((np.abs(centers) / max(t, 1e-12) * (nq - 1)).astype(
            int), 0, nq - 1)
        qs = np.bincount(b, p, nq)
        qc = np.bincount(b, inside.astype(float), nq)
        q = np.where(qc > 0, qs / np.maximum(qc, 1), 0)[b] * inside
        pn, qn = p / max(p.sum(), 1e-12), q / max(q.sum(), 1e-12)
        m = (pn > 0) & (qn > 0)
        out.append(float(np.sum(pn[m] * np.log(pn[m] / qn[m]))))
    return np.array(out)


@pytest.mark.parametrize("seed,bins,tail,nq", [(0, 512, 1.0, 255),
                                                (1, 2048, 0.5, 255),
                                                (2, 1024, 3.0, 127),
                                                (3, 256, 0.1, 31)])
def test_calibrate_entropy_threshold(seed, bins, tail, nq):
    hist, edges = _histogram(seed, bins, tail)
    kls = np.sort(_kls(hist, edges, nq))
    assert kls[1] - kls[0] > 1e-4 * max(kls[0], 1e-3), kls[:2]
    lo, hi = _equal("_contrib_calibrate_entropy", hist, edges,
                    num_quantized_bins=nq)
    assert lo == -hi and hi > 0


def test_the_tail_runs_on_meta_tensors_with_no_host_read():
    """Every op of the tail keeps its ranges on the device: on ``meta``
    tensors (no data to read) each returns outputs of the JAX op's
    shapes."""
    meta = torch.device("meta")

    def t(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=meta)

    s = t(())
    c = t((2, 3, 4, 4), torch.int8)
    cases = [
        ("_contrib_requantize", [t((2, 3), torch.int32), s, s], {}),
        ("_contrib_quantized_act", [c, s, s], {}),
        ("_contrib_quantized_concat", [c, c, s, s, s, s], {}),
        ("_contrib_quantized_elemwise_add", [c, c, s, s, s, s], {}),
        ("_contrib_quantized_elemwise_mul", [c, c, s, s, s, s], {}),
        ("_contrib_quantized_pooling", [c, s, s], {"stride": (2, 2)}),
        ("_contrib_quantized_batch_norm",
         [c, t((3,)), t((3,)), t((3,)), t((3,)), s, s], {}),
        ("_contrib_quantize_asym", [t((2, 3))], {}),
        ("_contrib_calibrate_entropy", [t((64,)), t((65,))], {}),
    ]
    for op, args, kw in cases:
        out = reg.get(op)(*args, **kw)
        assert all(o.device.type == "meta" for o in out), op
