"""``mx.random`` and the imperative ``mx.nd.Dropout`` of the port against
the JAX package's, on the CPU.

The JAX package draws its masks from threefry keys and the port from
torch's generators, so the two never give the same bits for one seed.
The tests compare what both must share: the drop rate, the scaling of
the kept values, when Dropout drops at all (train mode or
``mode="always"``), the shape of the mask along ``axes``; and, in the
port alone, that one seed repeats its mask and two seeds do not.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

P = 0.5
SHAPE = (256, 256)
RATE_LOW, RATE_HIGH = 0.45, 0.55   # 65,536 draws at p 0.5: sd 0.002
ROWS_LOW, ROWS_HIGH = 0.35, 0.65   # 256 whole rows at p 0.5: sd 0.031


def _ones():
    return np.ones(SHAPE, np.float32)


def _port(record, **kw):
    with mx.cpu():
        x = mx.nd.array(_ones())
        if record:
            with mx.autograd.record():
                return mx.nd.Dropout(x, p=P, **kw).asnumpy()
        return mx.nd.Dropout(x, p=P, **kw).asnumpy()


def _jax(record, **kw):
    x = jmx.nd.array(_ones())
    if record:
        with jmx.autograd.record():
            return jmx.nd.Dropout(x, p=P, **kw).asnumpy()
    return jmx.nd.Dropout(x, p=P, **kw).asnumpy()


def _assert_dropped(out, what):
    assert out.shape == SHAPE and out.dtype == np.float32, what
    kept = out != 0
    assert RATE_LOW <= 1 - kept.mean() <= RATE_HIGH, (what, kept.mean())
    assert (out[kept] == 1 / (1 - P)).all(), what


@pytest.mark.parametrize("package", [_port, _jax], ids=["port", "jax"])
def test_dropout_drops_under_record_at_rate_p_and_scales_kept(package):
    _assert_dropped(package(record=True), package.__name__)


@pytest.mark.parametrize("package", [_port, _jax], ids=["port", "jax"])
def test_dropout_is_the_identity_outside_record(package):
    np.testing.assert_array_equal(package(record=False), _ones())


@pytest.mark.parametrize("package", [_port, _jax], ids=["port", "jax"])
def test_dropout_mode_always_drops_outside_record(package):
    _assert_dropped(package(record=False, mode="always"), package.__name__)


@pytest.mark.parametrize("package", [_port, _jax], ids=["port", "jax"])
def test_dropout_axes_shares_the_mask_along_that_axis(package):
    out = package(record=True, axes=(1,))
    kept_rows = (out != 0).all(axis=1)
    dropped_rows = (out == 0).all(axis=1)
    assert (kept_rows | dropped_rows).all()
    assert ROWS_LOW <= dropped_rows.mean() <= ROWS_HIGH
    assert (out[kept_rows] == 1 / (1 - P)).all()


def test_dropout_p_zero_returns_a_copy_in_train_mode():
    with mx.cpu():
        x = mx.nd.array(_ones())
        with mx.autograd.record():
            y = mx.nd.Dropout(x, p=0.0)
    np.testing.assert_array_equal(y.asnumpy(), _ones())
    y._data.fill_(3.0)
    np.testing.assert_array_equal(x.asnumpy(), _ones())


def test_one_seed_repeats_the_mask_and_two_seeds_differ():
    masks = []
    for s in (7, 7, 8):
        mx.random.seed(s)
        masks.append(_port(record=True) != 0)
    assert np.array_equal(masks[0], masks[1])
    assert not np.array_equal(masks[0], masks[2])


def test_seed_reseeds_generators_made_before_it():
    mx.random.seed(11)
    first = _port(record=True)
    _port(record=True)            # the generator advances
    mx.random.seed(11, ctx=mx.cpu())
    np.testing.assert_array_equal(_port(record=True), first)


def test_current_seed_reports_the_seed():
    mx.random.seed(1234)
    assert mx.random.current_seed() == 1234
    jmx.random.seed(1234)
    assert jmx.random.current_seed() == 1234
    gen = mx.random.generator(mx.cpu())
    assert gen is mx.random.generator("cpu")
    assert gen.initial_seed() == 1234


def test_gluon_dropout_keeps_drawing_from_its_own_generator():
    """``gluon.nn.Dropout`` passes its generator through ``F.Dropout``:
    two blocks with generators of one seed drop the same elements, and
    ``mx.random.seed`` does not move them."""
    import torch

    outs = []
    for global_seed in (1, 2):
        mx.random.seed(global_seed)
        block = mx.gluon.nn.Dropout(
            P, generator=torch.Generator().manual_seed(5))
        with mx.cpu():
            x = mx.nd.array(_ones())
            with mx.autograd.record():
                outs.append(block(x).asnumpy())
            np.testing.assert_array_equal(block(x).asnumpy(), _ones())
    np.testing.assert_array_equal(outs[0], outs[1])
    _assert_dropped(outs[0], "gluon")


def test_dropout_gradient_flows_through_the_kept_elements():
    with mx.cpu():
        x = mx.nd.array(_ones())
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Dropout(x, p=P)
        y.backward()
        np.testing.assert_array_equal(x.grad.asnumpy(), y.asnumpy())
