"""The port's elementwise, scalar and broadcast ops (ops/math.py)
against the JAX package's on the same numpy inputs: each family's
forward, and for differentiable ops the gradient under
``autograd.record()`` / ``backward()`` with a fixed head gradient
against ``jax.vjp`` of the JAX op.

Tolerances: float32 rtol=1e-5, atol=1e-6 (both frameworks compute the
same expressions in different orders); integer-valued outputs exactly.
Comparisons and logical ops: the JAX package's tensor-tensor ones return
``bool``, the port's 1/0 in the input's dtype (MXNet's); the values are
held equal and the dtypes checked as such."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg

RTOL, ATOL = 1e-5, 1e-6
CPU = mx.cpu()


def _rand(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _jax(name, arrays, kw, argnums, heads):
    """The JAX op's outputs (a list) and, for ``argnums``, its
    gradients from ``heads``; the keywords pass the op's schema first,
    as in the JAX ``_invoke`` (``Operator.checked``), since the port's
    ``invoke`` coerces them so too."""
    fn = jreg.get(name).fn
    kw = jreg.get(name).check_kwargs(kw)
    args = [jnp.asarray(a) for a in arrays]

    def f(*diff):
        full = list(args)
        for i, d in zip(argnums, diff):
            full[i] = d
        return fn(*full, **kw)

    if not argnums:
        out = f()
        return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                        else (out,))], []
    out, vjp = jax.vjp(f, *[args[i] for i in argnums])
    single = not isinstance(out, tuple)
    cot = jnp.asarray(heads[0]) if single else tuple(
        jnp.asarray(h) for h in heads)
    grads = vjp(cot)
    outs = [out] if single else list(out)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port(name, arrays, kw, argnums, heads):
    with CPU:
        xs = [mx.nd.array(a) for a in arrays]
        for i in argnums:
            xs[i].attach_grad()
        with mx.autograd.record():
            out = mx.nd.invoke(name, *xs, **kw)
        outs = list(out) if isinstance(out, tuple) else [out]
        if argnums:
            mx.autograd.backward(outs, [mx.nd.array(h) for h in heads])
        return ([o.asnumpy() for o in outs],
                [xs[i].grad.asnumpy() for i in argnums])


def check(name, arrays, kw=None, argnums=(), bool_in_jax=False,
          rtol=RTOL, atol=ATOL):
    """Forward (and gradient over ``argnums``) of op ``name`` in both
    packages; returns the port's outputs."""
    kw = dict(kw or {})
    jout, _ = _jax(name, arrays, kw, (), None)
    rs = np.random.RandomState(7)
    heads = [np.asarray(rs.randn(*o.shape)).astype(
        o.dtype if np.issubdtype(o.dtype, np.floating) else np.float32)
        for o in jout]
    jout, jgrad = _jax(name, arrays, kw, argnums, heads)
    pout, pgrad = _port(name, arrays, kw, argnums, heads)
    assert len(pout) == len(jout)
    for p, j in zip(pout, jout):
        assert p.shape == j.shape, (name, p.shape, j.shape)
        if bool_in_jax and j.dtype == np.bool_:
            assert p.dtype == np.result_type(*[a.dtype for a in arrays])
            j = j.astype(p.dtype)
        assert p.dtype == j.dtype, (name, p.dtype, j.dtype)
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(p, j, rtol=rtol, atol=atol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(p, j, err_msg=name)
    for p, j in zip(pgrad, jgrad):
        np.testing.assert_allclose(p, j, rtol=rtol, atol=atol,
                                   err_msg=f"{name} gradient")
    return pout


# ------------------------------------------------------------ unary -------

_POS = ("sqrt", "rsqrt", "log", "log10", "log2", "gamma", "gammaln",
        "digamma")
_UNIT = ("arcsin", "arccos", "arctanh", "erfinv")
_NO_GRAD = ("sign", "round", "rint", "ceil", "floor", "trunc", "fix",
            "logical_not")
UNARY = ["negative", "abs", "sign", "round", "rint", "ceil", "floor",
         "trunc", "fix", "square", "sqrt", "rsqrt", "cbrt", "exp",
         "expm1", "log", "log10", "log2", "log1p", "sin", "cos", "tan",
         "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
         "arccosh", "arctanh", "erf", "erfinv", "gamma", "gammaln",
         "sigmoid", "softsign", "relu", "reciprocal", "logical_not"]


def _unary_input(name):
    if name in _POS:
        return _rand(3, 7, lo=0.2, hi=3.0)
    if name in _UNIT:
        return _rand(3, 7, lo=-0.9, hi=0.9)
    if name == "arccosh":
        return _rand(3, 7, lo=1.1, hi=4.0)
    if name == "log1p":
        return _rand(3, 7, lo=-0.5, hi=3.0)
    if name == "reciprocal":
        return _rand(3, 7, lo=0.3, hi=2.0) * np.where(
            np.arange(21).reshape(3, 7) % 2, 1, -1).astype(np.float32)
    x = _rand(3, 7)
    if name in ("round", "rint"):
        # halves: both round half to even
        x[0, :4] = [0.5, 1.5, -2.5, 2.5]
    if name in ("abs", "sign", "relu", "logical_not"):
        x[1, :2] = 0.0   # the gradient (and value) at 0 must match
    if name == "cbrt":
        x[np.abs(x) < 0.1] = 0.5
    return x


# lgamma near its roots (x = 1, 2) cancels: the two libraries' float32
# values there differ by about one ulp of lgamma's terms (~1e-6)
_ATOL = {"gammaln": 4e-6}


@pytest.mark.parametrize("name", UNARY)
def test_unary(name):
    x = _unary_input(name)
    check(name, [x], argnums=() if name in _NO_GRAD else (0,),
          bool_in_jax=name == "logical_not", atol=_ATOL.get(name, ATOL))


def test_unary_on_integers_keeps_or_promotes_the_dtype_as_jax():
    x = np.arange(-3, 4, dtype=np.int32)
    for name in ("negative", "abs", "square", "sign"):
        check(name, [x])
    for name in ("exp", "sqrt", "log"):
        check(name, [np.abs(x) + 1])


# ----------------------------------------------------------- binary -------

BINARY = ["add", "sub", "mul", "div", "mod", "power", "maximum", "minimum",
          "hypot", "equal", "not_equal", "greater", "greater_equal",
          "lesser", "lesser_equal", "logical_and", "logical_or",
          "logical_xor", "arctan2"]
_CMP = ("equal", "not_equal", "greater", "greater_equal", "lesser",
        "lesser_equal", "logical_and", "logical_or", "logical_xor")


def _binary_inputs(name, shape_a, shape_b):
    a, b = _rand(*shape_a, seed=1), _rand(*shape_b, seed=2)
    if name == "power":
        a = np.abs(a) + 0.5
    if name == "mod":
        b = np.where(np.abs(b) < 0.3, 0.7, b).astype(np.float32)
    if name in _CMP or name in ("maximum", "minimum"):
        # ties: equal values compare equal and share the gradient
        a.reshape(-1)[:3] = 1.0
        if b.size >= 3:
            b.reshape(-1)[:3] = 1.0
        a.reshape(-1)[3:5] = 0.0
    return a, b


@pytest.mark.parametrize("kind", ["elemwise", "broadcast"])
@pytest.mark.parametrize("name", BINARY)
def test_binary(name, kind):
    shapes = ((3, 4, 5), (3, 4, 5)) if kind == "elemwise" else \
        ((3, 1, 5), (1, 4, 5))
    a, b = _binary_inputs(name, *shapes)
    check(f"{kind}_{name}", [a, b],
          argnums=() if name in _CMP else (0, 1), bool_in_jax=True)


@pytest.mark.parametrize("name", ["_add", "_sub", "_mul", "_div", "_mod",
                                  "_power", "_maximum", "_equal"])
def test_elemwise_aliases(name):
    a, b = _binary_inputs(name[1:], (2, 6), (2, 6))
    check(name, [a, b], bool_in_jax=True)


def test_elemwise_needs_one_shape_and_broadcast_does_not():
    a, b = _rand(2, 3), _rand(1, 3)
    with CPU, pytest.raises(ValueError, match="identical shapes"):
        mx.nd.elemwise_add(mx.nd.array(a), mx.nd.array(b))
    check("broadcast_add", [a, b], argnums=(0, 1))


def test_mod_follows_the_divisor_sign_as_jnp_mod():
    a = np.array([5.0, -5.0, 5.0, -5.0, 7.5], np.float32)
    b = np.array([3.0, 3.0, -3.0, -3.0, 2.0], np.float32)
    out = check("broadcast_mod", [a, b], argnums=(0, 1))[0]
    np.testing.assert_array_equal(out, np.mod(a, b))


# ----------------------------------------------------------- scalar -------

SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
          "_div_scalar", "_rdiv_scalar", "_mod_scalar", "_rmod_scalar",
          "_power_scalar", "_rpower_scalar", "_maximum_scalar",
          "_minimum_scalar", "_equal_scalar", "_not_equal_scalar",
          "_greater_scalar", "_greater_equal_scalar", "_lesser_scalar",
          "_lesser_equal_scalar"]
_SCALAR_CMP = tuple(n for n in SCALAR if "equal" in n or "greater" in n
                    or "lesser" in n)


@pytest.mark.parametrize("name", SCALAR)
def test_scalar(name):
    x = _rand(4, 6, seed=3)
    if name in ("_rdiv_scalar", "_rmod_scalar", "_power_scalar"):
        x = np.abs(x) + 0.4
    x.reshape(-1)[:2] = 1.5        # ties with the scalar
    check(name, [x], {"scalar": 1.5},
          argnums=() if name in _SCALAR_CMP else (0,))


@pytest.mark.parametrize("name", ["_plus_scalar", "_mul_scalar",
                                  "_greater_scalar", "_mod_scalar"])
def test_scalar_on_integers(name):
    x = np.arange(-4, 8, dtype=np.int32).reshape(3, 4)
    check(name, [x], {"scalar": 3})
    check(name, [x], {"scalar": 2.5})


# ------------------------------------------------------------- misc -------

MISC = [
    ("copy", [_rand(3, 4)], {}, (0,)),
    ("identity", [_rand(3, 4)], {}, (0,)),
    ("_copy", [_rand(3, 4)], {}, (0,)),
    ("zeros_like", [_rand(3, 4)], {}, ()),
    ("ones_like", [_rand(3, 4)], {}, ()),
    ("hard_sigmoid", [_rand(4, 5, lo=-4, hi=4)], {}, (0,)),
    ("hard_sigmoid", [_rand(4, 5, lo=-4, hi=4)], {"alpha": 0.3,
                                                  "beta": 0.4}, (0,)),
    ("softplus", [_rand(4, 5, lo=-30, hi=30)], {}, (0,)),
    ("degrees", [_rand(4, 5)], {}, (0,)),
    ("radians", [_rand(4, 5) * 90], {}, (0,)),
    ("clip", [_rand(4, 5)], {"a_min": -0.5, "a_max": 0.5}, (0,)),
    ("clip", [_rand(4, 5)], {"a_min": None, "a_max": 0.5}, (0,)),
    ("clip", [_rand(4, 5)], {"a_min": -0.5}, (0,)),
    ("clip", [np.array([-0.5, 0.5, 0.0, 1.0], np.float32)],
     {"a_min": -0.5, "a_max": 0.5}, (0,)),   # ties at both bounds
    ("Cast", [_rand(4, 5) * 10], {"dtype": "int32"}, ()),
    ("cast", [_rand(4, 5)], {"dtype": "float16"}, (0,)),
    ("Cast", [np.arange(6, dtype=np.int32)], {"dtype": "float32"}, ()),
    ("amp_cast", [_rand(4, 5)], {"dtype": "float16"}, (0,)),
    ("broadcast_like", [_rand(1, 5), _rand(4, 5)], {}, (0,)),
    ("broadcast_to", [_rand(3, 1, 5)], {"shape": (3, 4, 5)}, (0,)),
    ("broadcast_axis", [_rand(3, 1, 1)], {"axis": (1, 2),
                                          "size": (4, 2)}, (0,)),
]


@pytest.mark.parametrize("case", MISC, ids=lambda c: c[0])
def test_misc(case):
    name, arrays, kw, argnums = case
    check(name, arrays, kw, argnums)


def test_cast_rounds_toward_zero():
    x = np.array([-2.7, -0.5, 0.5, 2.7, 3.0], np.float32)
    out = check("Cast", [x], {"dtype": "int32"})[0]
    np.testing.assert_array_equal(out, [-2, 0, 0, 2, 3])
