"""The port's ops (mxnet_tpu_torch/ops) against the JAX package's
registered ops on the same numpy inputs, plus the port's NDArray and
initializer basics."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import nd

# f32 on the CPU: both frameworks compute the same expressions in
# different orders
RTOL, ATOL = 1e-5, 1e-6
CPU = mx.cpu()


def _jax(name, *arrays, **kw):
    return np.asarray(jreg.get(name).fn(*(jnp.asarray(a) for a in arrays),
                                        **kw))


def _port(name, *arrays, **kw):
    out = getattr(nd, name)(*(nd.array(a, ctx=CPU) for a in arrays), **kw)
    return out.asnumpy()


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("flatten", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_fully_connected(flatten, bias):
    x, w = _rand(3, 5, 8), _rand(6, 40 if flatten else 8, seed=1)
    args = (x, w, _rand(6, seed=2)) if bias else (x, w)
    kw = {"num_hidden": 6, "flatten": flatten, "no_bias": not bias}
    np.testing.assert_allclose(_port("FullyConnected", *args, **kw),
                               _jax("FullyConnected", *args, **kw),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm(axis):
    x = _rand(2, 6, 10) * 3 + 1
    c = x.shape[axis]
    g, b = _rand(c, seed=1), _rand(c, seed=2)
    np.testing.assert_allclose(_port("LayerNorm", x, g, b, axis=axis),
                               _jax("LayerNorm", x, g, b, axis=axis),
                               rtol=RTOL, atol=ATOL)


def test_gelu_is_exact_erf():
    x = _rand(4, 33) * 3
    np.testing.assert_allclose(_port("LeakyReLU", x, act_type="gelu"),
                               _jax("LeakyReLU", x, act_type="gelu"),
                               rtol=RTOL, atol=ATOL)
    # the other modes are ported (tests/test_torch_nn_surface.py)
    np.testing.assert_allclose(_port("LeakyReLU", x, act_type="elu"),
                               _jax("LeakyReLU", x, act_type="elu"),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act", ["tanh", "relu", "sigmoid"])
def test_activation(act):
    x = _rand(5, 7)
    np.testing.assert_allclose(_port("Activation", x, act_type=act),
                               _jax("Activation", x, act_type=act),
                               rtol=RTOL, atol=ATOL)


def test_embedding_casts_float_ids():
    w = _rand(50, 6)
    ids = np.array([[0, 3.0, 49], [7, 7, 1]], np.float32)
    kw = {"input_dim": 50, "output_dim": 6}
    np.testing.assert_array_equal(_port("Embedding", ids, w, **kw),
                                  _jax("Embedding", ids, w, **kw))


@pytest.mark.parametrize("shape", [(0, 0, 4, -1), (0, -1), (-1, 5),
                                   (0, -2), (2, 0, 2, 10)])
def test_reshape_codes(shape):
    x = _rand(2, 3, 20)
    np.testing.assert_array_equal(_port("reshape", x, shape=shape),
                                  _jax("reshape", x, shape=shape))


def test_transpose_flatten_slice_axis():
    x = _rand(2, 3, 4, 5)
    for axes in [(0, 2, 1, 3), ()]:
        np.testing.assert_array_equal(_port("transpose", x, axes=axes),
                                      _jax("transpose", x, axes=axes))
    np.testing.assert_array_equal(_port("Flatten", x), _jax("Flatten", x))
    kw = {"axis": 1, "begin": 0, "end": 1}
    np.testing.assert_array_equal(_port("slice_axis", x, **kw),
                                  _jax("slice_axis", x, **kw))
    np.testing.assert_array_equal(
        nd.invoke("slice_axis", nd.array(x, ctx=CPU), axis=2, begin=1,
                  end=3).asnumpy(), x[:, :, 1:3])


def _op(name, *arrays, **kw):
    """The registered op itself, past ``nd``'s overrides."""
    return nd.invoke(name, *(nd.array(a, ctx=CPU) for a in arrays),
                     **kw).asnumpy()


def test_dropout_identity_unless_training_with_explicit_generator():
    """The ``Dropout`` op (``nd.Dropout`` is MXNet's imperative override
    over it: tests/test_torch_random.py)."""
    x = _rand(64, 64)
    np.testing.assert_array_equal(_op("Dropout", x, p=0.5), x)
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    a = _op("Dropout", x, p=0.5, training=True, generator=g1)
    b = _op("Dropout", x, p=0.5, training=True, generator=g2)
    np.testing.assert_array_equal(a, b)
    kept = a != 0
    assert 0.4 < kept.mean() < 0.6
    np.testing.assert_allclose(a[kept], x[kept] * 2, rtol=1e-6)
    with pytest.raises(mx.MXNetError, match="Generator"):
        _op("Dropout", x, p=0.5, training=True)


def test_ndarray_handle_basics():
    x = nd.array(_rand(3, 4), ctx=CPU)
    assert x.shape == (3, 4) and x.dtype == torch.float32
    assert x.context == CPU and x.as_in_context(CPU) is x
    np.testing.assert_array_equal((x + x).asnumpy(), x.asnumpy() * 2)
    np.testing.assert_array_equal(x[1:, 2].asnumpy(), x.asnumpy()[1:, 2])
    assert nd.array([1, 2], ctx=CPU).dtype == torch.float32
    assert nd.array(np.arange(3), ctx=CPU).dtype == torch.int64
    bf = x.astype("bfloat16")
    assert bf.dtype == torch.bfloat16 and bf.asnumpy().dtype == np.float32
    with pytest.raises(TypeError, match="NDArray"):
        nd.Flatten(np.zeros((2, 2)))


@pytest.mark.parametrize("init,check", [
    ("xavier", lambda w: np.abs(w).max() <= np.sqrt(3 / ((30 + 20) / 2))),
    ("zeros", lambda w: (w == 0).all()),
    ("ones", lambda w: (w == 1).all()),
    ("uniform", lambda w: np.abs(w).max() <= 0.07),
    ("normal", lambda w: 0.005 < w.std() < 0.015),
])
def test_initializers_draw_from_explicit_generator(init, check):
    def make(seed):
        d = mx.gluon.nn.Dense(30, in_units=20)
        d.initialize(init, ctx=CPU,
                     generator=torch.Generator().manual_seed(seed))
        return d.weight.data().asnumpy(), d.bias.data().asnumpy()

    w, b = make(0)
    assert check(w) and (b == 0).all()
    np.testing.assert_array_equal(w, make(0)[0])
