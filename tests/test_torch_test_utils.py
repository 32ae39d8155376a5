"""``mx.test_utils`` of the port against the JAX package's: the per-dtype
tolerances, ``same``/``almost_equal``/``assert_almost_equal`` verdicts
and messages, ``default_context`` under ``MXNET_TEST_DEVICE``,
``check_numeric_gradient`` and ``check_consistency`` on the CPU, the
``rand_*`` helpers and ``environment``."""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import test_utils as jtu
from mxnet_tpu_torch import test_utils as tu


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64",
                                   "int32"])
def test_tolerances_are_the_jax_packages(dtype):
    a = np.ones(3, dtype)
    assert tu._dtype_tol(a, a) == jtu._dtype_tol(a, a)


def test_verdicts_and_messages():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = a + np.array([0, 0, 1e-3], np.float32)
    with mx.cpu():
        pa = mx.nd.array(a)
    assert tu.same(pa, a) and jtu.same(jmx.nd.array(a), a)
    assert tu.almost_equal(a, a + 1e-7) == jtu.almost_equal(a, a + 1e-7)
    assert tu.almost_equal(a, b) == jtu.almost_equal(a, b) is False
    with pytest.raises(AssertionError) as pe:
        tu.assert_almost_equal(a, b, names=("x", "y"))
    with pytest.raises(AssertionError) as je:
        jtu.assert_almost_equal(a, b, names=("x", "y"))
    assert str(pe.value) == str(je.value)


def test_default_context_from_the_environment(monkeypatch):
    monkeypatch.setattr(tu, "_default_ctx", None)
    monkeypatch.setenv("MXNET_TEST_DEVICE", "cpu:0")
    assert tu.default_context() == mx.cpu(0)
    tu.set_default_context(mx.cpu(0))
    assert tu.default_context() == mx.cpu(0)


def test_numeric_gradient_and_consistency_on_the_cpu():
    rs = np.random.RandomState(0)
    x = rs.uniform(0.5, 1.5, (3, 4))
    tu.check_numeric_gradient("tanh", [x])
    tu.check_numeric_gradient("broadcast_mul", [x, rs.rand(3, 4)])
    out = tu.check_consistency(lambda a, b: mx.nd.dot(a, b),
                               [(3, 4), (4, 2)],
                               ctx_list=[mx.cpu(0), mx.cpu(0)])
    assert out.shape == (3, 2)
    with mx.cpu():
        tu.set_default_context(mx.cpu())
        np.testing.assert_allclose(tu.simple_forward("relu", x - 1.0),
                                   np.maximum(x - 1.0, 0), rtol=1e-6)


def test_rand_helpers_and_environment():
    np.random.seed(0)
    shape = tu.rand_shape_nd(3, dim=5)
    assert len(shape) == 3 and all(1 <= s <= 5 for s in shape)
    with mx.cpu():
        a = tu.rand_ndarray((4, 3), ctx=mx.cpu())
        assert a.shape == (4, 3) and a.dtype == mx.nd.array([1.0]).dtype
        r = tu.rand_ndarray((6, 3), stype="row_sparse", density=0.5,
                            ctx=mx.cpu())
        assert r.stype == "row_sparse"
    with tu.environment("MXNET_TEST_ENV_PROBE", "1"):
        assert os.environ["MXNET_TEST_ENV_PROBE"] == "1"
    assert "MXNET_TEST_ENV_PROBE" not in os.environ
