"""The port's ``mx.nd`` functions and ``NDArray`` methods against the
JAX package's on the same numpy inputs (float32 rtol=1e-5, atol=1e-6;
integer values exactly). Comparisons return 1/0 in the input's dtype in
the port (MXNet's), ``bool`` in the JAX package: values are held equal."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

RTOL, ATOL = 1e-5, 1e-6
CPU = mx.cpu()


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-2, 2, shape).astype(
        np.float32)


def _same(got, want):
    got, want = [x if isinstance(x, (list, tuple)) else [x]
                 for x in (got, want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.asnumpy(), w.asnumpy()
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype == np.bool_:
            w = w.astype(g.dtype)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


FUNCTIONS = [
    ("ones", ((2, 3),), {}), ("ones", (4,), {"dtype": "int32"}),
    ("full", ((2, 2), 3.5), {}), ("full", (3, 7), {"dtype": "int32"}),
    ("empty", ((2, 3),), {}),
    ("zeros", (5,), {}),
    ("arange", (5,), {}), ("arange", (1, 4, 0.5), {}),
    ("arange", (0, 6, 2), {"repeat": 2}),
    ("arange", (2, 9), {"dtype": "int32"}),
    ("eye", (3,), {}), ("eye", (3, 4, 1), {}), ("eye", (4, 3, -1),
                                                {"dtype": "int32"}),
]


@pytest.mark.parametrize("case", FUNCTIONS, ids=lambda c: c[0])
def test_creation_functions(case):
    name, args, kw = case
    with CPU:
        got = getattr(mx.nd, name)(*args, **kw)
    _same(got, getattr(jmx.nd, name)(*args, **kw))


def test_creation_defaults_to_the_card():
    """Every creation function places its array on ``current_context()``,
    which is ``gpu(0)`` unless a scope says otherwise."""
    assert mx.current_context() == mx.gpu(0)
    for fn, args in ((mx.nd.ones, ((2,),)), (mx.nd.full, ((2,), 1.0)),
                     (mx.nd.empty, ((2,),)), (mx.nd.arange, (3,)),
                     (mx.nd.eye, (2,)), (mx.nd.zeros, ((2,),))):
        if torch.cuda.is_available():
            assert fn(*args).context == mx.gpu(0)
        else:
            with pytest.raises(mx.MXNetError, match="CUDA card"):
                fn(*args)
        with CPU:
            assert fn(*args).context == CPU
        assert fn(*args, ctx=CPU).context == CPU


JOINS = [
    ("concat", lambda nd, a, b: nd.concat(a, b, dim=0)),
    ("concat_list", lambda nd, a, b: nd.concat([a, b], dim=1)),
    ("stack", lambda nd, a, b: nd.stack(a, b, axis=1)),
    ("stack_list", lambda nd, a, b: nd.stack([a, b])),
    ("split", lambda nd, a, b: nd.split(a, 3, axis=1)),
    ("split_squeeze", lambda nd, a, b: nd.split(a, 2, axis=0,
                                                squeeze_axis=True)),
    ("moveaxis", lambda nd, a, b: nd.moveaxis(nd.stack(a, b), 0, -1)),
    ("dot", lambda nd, a, b: nd.dot(a, b, transpose_b=True)),
    ("zeros_like", lambda nd, a, b: nd.zeros_like(a)),
    ("ones_like", lambda nd, a, b: nd.ones_like(b)),
]


@pytest.mark.parametrize("case", JOINS, ids=lambda c: c[0])
def test_joining_functions(case):
    _, fn = case
    a, b = _rand(2, 3), _rand(2, 3, seed=1)
    with CPU:
        got = fn(mx.nd, mx.nd.array(a), mx.nd.array(b))
    _same(got, fn(jmx.nd, jmx.nd.array(a), jmx.nd.array(b)))


def test_waitall_returns_after_the_work():
    with CPU:
        x = mx.nd.ones((4, 4)) * 2
    mx.nd.waitall()
    assert float(x.sum().asscalar()) == 32.0


OPERATORS = [
    ("add", lambda a, b: a + b), ("radd", lambda a, b: 2.5 + a),
    ("sub", lambda a, b: a - b), ("rsub", lambda a, b: 1.0 - a),
    ("mul", lambda a, b: a * 3), ("div", lambda a, b: a / b),
    ("rdiv", lambda a, b: 2.0 / b), ("mod", lambda a, b: a % 0.7),
    ("rmod", lambda a, b: 3.0 % b), ("mod_nd", lambda a, b: a % b),
    ("pow", lambda a, b: abs(a) ** 1.5), ("rpow", lambda a, b: 2.0 ** a),
    ("pow_nd", lambda a, b: abs(a) ** b), ("neg", lambda a, b: -a),
    ("abs", lambda a, b: abs(a)),
    ("eq", lambda a, b: a == b), ("ne", lambda a, b: a != 0.5),
    ("gt", lambda a, b: a > b), ("ge", lambda a, b: a >= 0.0),
    ("lt", lambda a, b: a < b), ("le", lambda a, b: 0.5 >= a),
    ("broadcast", lambda a, b: a + b[:1]),
    ("numpy_rhs", lambda a, b: a * np.full((2, 3), 2.0, np.float32)),
]


@pytest.mark.parametrize("case", OPERATORS, ids=lambda c: c[0])
def test_operators(case):
    _, fn = case
    a, b = _rand(2, 3), _rand(2, 3, seed=1)
    a[0, 0] = b[0, 0]      # a tie for the comparisons
    b[np.abs(b) < 0.2] = 0.5
    with CPU:
        got = fn(mx.nd.array(a), mx.nd.array(b))
    _same(got, fn(jmx.nd.array(a), jmx.nd.array(b)))


def test_floor_division():
    a, b = _rand(2, 3), _rand(2, 3, seed=1) + 3
    with CPU:
        x, y = mx.nd.array(a), mx.nd.array(b)
        np.testing.assert_array_equal((x // y).asnumpy(), a // b)
        np.testing.assert_array_equal((x // 0.5).asnumpy(), a // 0.5)
        np.testing.assert_array_equal((7.0 // y).asnumpy(), 7.0 // b)


@pytest.mark.parametrize("op", ["__iadd__", "__isub__", "__imul__",
                                "__itruediv__"])
def test_in_place_operators_rebind(op):
    a, b = _rand(2, 3), _rand(2, 3, seed=1) + 3
    with CPU:
        x = mx.nd.array(a)
        got = getattr(x, op)(mx.nd.array(b))
        assert got is x
    want = getattr(jmx.nd.array(a), op)(jmx.nd.array(b))
    _same(x, want)


METHODS = [
    ("sum", (), {"axis": 1}), ("mean", (), {}), ("max", (), {"axis": 0}),
    ("min", (), {"keepdims": True}), ("prod", (), {"axis": 1}),
    ("norm", (), {}), ("argmax", (), {"axis": 1}), ("argmin", (), {}),
    ("argsort", (), {}), ("sort", (), {"is_ascend": False}),
    ("topk", (), {"k": 2}), ("clip", (-0.5, 0.5), {}), ("exp", (), {}),
    ("sqrt", (), {}), ("square", (), {}), ("sigmoid", (), {}),
    ("relu", (), {}), ("tanh", (), {}), ("sign", (), {}), ("log", (), {}),
    ("abs", (), {}), ("softmax", (), {}), ("log_softmax", (), {}),
    ("expand_dims", (1,), {}), ("flatten", (), {}), ("tile", ((2, 1),), {}),
    ("repeat", (2,), {"axis": 0}), ("flip", (1,), {}),
    ("swapaxes", (0, 1), {}), ("split", (3,), {}),
    ("zeros_like", (), {}), ("ones_like", (), {}),
    ("astype", ("int32",), {}), ("broadcast_to", ((2, 2, 3),), {}),
    ("reshape", ((3, 2),), {}), ("reshape", (6,), {}),
    ("transpose", (), {}), ("copy", (), {}),
    ("slice_axis", (1, 0, 2), {}),
    ("pad", (), {"mode": "constant", "pad_width": (0, 0, 1, 1),
                 "constant_value": 0.0}),
]


@pytest.mark.parametrize("case", METHODS, ids=lambda c: c[0])
def test_methods(case):
    name, args, kw = case
    a = np.abs(_rand(2, 3)) + 0.1 if name in ("sqrt", "log") else _rand(2, 3)
    if name == "pad":
        a = a.reshape(1, 1, 2, 3)
        kw = dict(kw, pad_width=(0, 0, 0, 0, 1, 1, 0, 2))
    with CPU:
        got = getattr(mx.nd.array(a), name)(*args, **kw)
    _same(got, getattr(jmx.nd.array(a), name)(*args, **kw))


def test_methods_of_two_arrays():
    a, b = _rand(2, 3), _rand(3, 2, seed=1)
    idx = np.array([1.0, 0.0, 1.0], np.float32)
    for fn in (lambda x, y, i: x.dot(y),
               lambda x, y, i: x.reshape_like(y),
               lambda x, y, i: x[:1].broadcast_like(x),
               lambda x, y, i: x.take(i),
               lambda x, y, i: i.one_hot(3),
               lambda x, y, i: x.T):
        with CPU:
            got = fn(mx.nd.array(a), mx.nd.array(b), mx.nd.array(idx))
        _same(got, fn(jmx.nd.array(a), jmx.nd.array(b), jmx.nd.array(idx)))


def test_properties_and_copies():
    a = _rand(2, 3, 4)
    with CPU:
        x = mx.nd.array(a)
        assert (x.size, x.ndim, x.T.shape) == (24, 3, (4, 3, 2))
        y = x.copy()
        assert y._data.data_ptr() != x._data.data_ptr()
        z = mx.nd.zeros((2, 3, 4))
        assert x.copyto(z) is z
        np.testing.assert_array_equal(z.asnumpy(), a)
        assert x.slice(begin=(0, 1), end=(1, 3)).shape == (1, 2, 4)
        assert x.squeeze().shape == (2, 3, 4)
        assert x[0:1].squeeze(axis=0).shape == (3, 4)
        assert float(x[1, 2, 3]) == pytest.approx(float(a[1, 2, 3]))
        assert bool(mx.nd.array([1.0]) > 0)
        with pytest.raises(ValueError, match="ambiguous"):
            bool(x)
        x[0] = 0.0
        x[1, :, 1] = mx.nd.ones((3,))
    b = a.copy()
    b[0] = 0.0
    b[1, :, 1] = 1.0
    np.testing.assert_array_equal(x.asnumpy(), b)


def test_methods_carry_gradients():
    a = _rand(2, 3)
    with CPU:
        x = mx.nd.array(a)
        x.attach_grad()
        with mx.autograd.record():
            y = ((x * 2 + 1) ** 2 / 3 - x.exp()).sum(axis=1).mean()
        y.backward()
    want = (4 * (2 * a + 1) / 3 - np.exp(a)) / 2
    np.testing.assert_allclose(x.grad.asnumpy(), want, rtol=1e-5,
                               atol=1e-5)
