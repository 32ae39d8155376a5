"""The port's convolution, pooling and BatchNorm ops on the CPU against
the JAX package's (``mxnet_tpu/ops/nn.py``: Convolution :60, Pooling
:118, _contrib_AdaptiveAvgPooling2D :180, BatchNorm :202): the same
numpy inputs through both, the forward and the gradient of ``sum(out *
dy)`` with respect to every input against ``jax.grad`` of the JAX op.

Tolerances (float32, different summation orders in the two frameworks'
convolutions and reductions): forward rtol = atol = 1e-5, gradients
rtol = atol = 1e-4, both relative to the largest magnitude of the
reference (``_close``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as preg

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _close(got, want, tol, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.nanmax(np.abs(want))), 1.0)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * scale, err_msg=what)


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _parity(op, arrays, kw, diff=None, seed=0):
    """Forward and gradients of op ``op`` in both packages; ``diff``: the
    indices of ``arrays`` to differentiate (default: all). Returns the
    port's outputs (a tuple)."""
    diff = list(range(len(arrays))) if diff is None else diff
    jfn = jreg.get(op).fn
    want = jfn(*[jnp.asarray(a) for a in arrays], **kw)
    dy = np.random.RandomState(seed).randn(
        *_first(want).shape).astype(np.float32)

    def loss(*xs):
        args = [jnp.asarray(a) for a in arrays]
        for i, x in zip(diff, xs):
            args[i] = x
        return jnp.sum(_first(jfn(*args, **kw)) * dy)

    jgrads = jax.grad(loss, argnums=tuple(range(len(diff))))(
        *[jnp.asarray(arrays[i]) for i in diff])
    ts = [torch.tensor(a, requires_grad=i in diff)
          for i, a in enumerate(arrays)]
    got = preg.get(op)(*ts, **kw)
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    assert len(outs) == len(wants)
    for k, (o, w) in enumerate(zip(outs, wants)):
        assert tuple(o.shape) == tuple(w.shape), (op, k)
        _close(o.detach().numpy(), w, FWD_TOL, f"{op} output {k}")
    (_first(got) * torch.from_numpy(dy)).sum().backward()
    for i, g in zip(diff, jgrads):
        pg = ts[i].grad
        pg = np.zeros(ts[i].shape) if pg is None else pg.numpy()
        _close(pg, g, GRAD_TOL, f"{op} gradient of input {i}")
    return outs


def _rand(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


CONV_CASES = [
    # (data shape, weight shape, hyper-parameters)
    ((2, 4, 17), (6, 4, 3), dict(kernel=(3,), stride=(2,), pad=(1,),
                                 dilate=(2,), num_filter=6)),
    ((2, 4, 9, 9), (8, 4, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1), num_filter=8,
                                      no_bias=True)),
    ((2, 4, 9, 8), (6, 2, 3, 2), dict(kernel=(3, 2), stride=(1, 2),
                                      pad=(2, 0), dilate=(2, 1),
                                      num_filter=6, num_group=2)),
    ((2, 6, 7, 7), (6, 1, 3, 3), dict(kernel=(3, 3), pad=(1, 1),
                                      num_filter=6, num_group=6)),
    ((2, 8, 14, 14), (16, 8, 1, 1), dict(kernel=(1, 1), stride=(2, 2),
                                         num_filter=16)),
    ((1, 3, 5, 6, 7), (4, 3, 3, 3, 2), dict(kernel=(3, 3, 2),
                                            stride=(1, 2, 1),
                                            pad=(1, 1, 0), num_filter=4)),
]


@pytest.mark.parametrize("dshape,wshape,kw", CONV_CASES)
def test_convolution_matches_jax(dshape, wshape, kw):
    rs = np.random.RandomState(len(dshape) * 10 + wshape[0])
    arrays = [_rand(rs, *dshape), _rand(rs, *wshape, scale=0.3)]
    if not kw.get("no_bias"):
        arrays.append(_rand(rs, wshape[0]))
    _parity("Convolution", arrays, kw)


POOL_CASES = [
    ((2, 3, 11, 10), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type=pt, pooling_convention=conv))
    for pt in ("max", "avg", "sum") for conv in ("valid", "full", "same")
] + [
    ((2, 3, 11, 10), dict(kernel=(3, 2), stride=(2, 3), pad=(1, 1),
                          pool_type="avg", pooling_convention=conv,
                          count_include_pad=False))
    for conv in ("valid", "full", "same")
] + [
    ((2, 3, 12), dict(kernel=(4,), stride=(3,), pad=(1,), pool_type="max",
                      pooling_convention="full")),
    ((2, 3, 12), dict(kernel=(2,), pool_type="avg")),
    ((1, 2, 5, 6, 7), dict(kernel=(2, 3, 2), stride=(2, 2, 3),
                           pool_type="max")),
    ((1, 2, 5, 6, 7), dict(kernel=(3, 3, 3), stride=(2, 2, 2),
                           pad=(1, 1, 1), pool_type="avg",
                           count_include_pad=False)),
    ((2, 3, 11, 10), dict(kernel=(4, 4), stride=(1, 1), pad=(2, 1),
                          pool_type="max")),
    # the ResNet stem's MaxPool2D(3, 2, 1) after a relu
    ((2, 4, 16, 16), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="max", relu=True)),
] + [
    ((2, 3, 5, 6), dict(kernel=(1, 1), pool_type=pt, global_pool=True))
    for pt in ("max", "avg", "sum")
] + [
    ((2, 3, 7), dict(kernel=(1,), pool_type="avg", global_pool=True)),
    ((1, 2, 3, 4, 5), dict(kernel=(1, 1, 1), pool_type="max",
                           global_pool=True)),
]


@pytest.mark.parametrize("shape,kw", POOL_CASES)
def test_pooling_matches_jax(shape, kw):
    kw = dict(kw)
    rs = np.random.RandomState(sum(shape))
    x = _rand(rs, *shape)
    if kw.pop("relu", False):
        x = np.maximum(x, 0)
    _parity("Pooling", [x], kw)


def test_lp_pooling_raises_as_in_jax():
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(NotImplementedError):
        preg.get("Pooling")(x, kernel=(2, 2), pool_type="lp")


@pytest.mark.parametrize("shape,size", [((2, 3, 8, 12), (2, 3)),
                                        ((2, 3, 7, 10), (3, 4)),
                                        ((1, 2, 5, 5), 1)])
def test_adaptive_avg_pooling_matches_jax(shape, size):
    x = _rand(np.random.RandomState(shape[2]), *shape)
    _parity("_contrib_AdaptiveAvgPooling2D", [x], dict(output_size=size))


@pytest.mark.parametrize("kw", [
    dict(eps=1e-5, fix_gamma=False, training=True),
    dict(eps=1e-3, fix_gamma=True, training=True),
    dict(eps=1e-5, fix_gamma=False, use_global_stats=True, training=True),
    dict(eps=1e-5, fix_gamma=False, training=False),
    dict(eps=1e-5, fix_gamma=False, training=True, axis=-1),
], ids=["train", "fix_gamma", "use_global_stats", "eval", "last_axis"])
@pytest.mark.parametrize("shape", [(4, 5, 6, 7), (8, 3)])
def test_batch_norm_three_outputs_and_gradients_match_jax(kw, shape):
    """Output, batch (or moving) mean and biased variance, and the
    gradients with respect to data, gamma and beta (the moving statistics
    are aux state: not differentiated)."""
    rs = np.random.RandomState(len(shape))
    c = shape[kw.get("axis", 1)]
    x = _rand(rs, *shape, scale=2.0) + 3.0
    gamma = rs.rand(c).astype(np.float32) + 0.5
    beta = _rand(rs, c)
    mm = _rand(rs, c)
    mv = rs.rand(c).astype(np.float32) + 0.5
    _parity("BatchNorm", [x, gamma, beta, mm, mv], kw, diff=[0, 1, 2])
