"""mx.np and mx.npx of the port against the JAX package's, case for case
from tests/test_numpy.py (the same numpy inputs through both, each also
held against numpy as there), plus the dtypes of every unary, binary,
scalar and reduction op on int32, bool and float32 inputs against the JAX
ops'.

Tolerances: the numpy oracle's of each case in tests/test_numpy.py
(rtol 1e-5 or 1e-4, atol 1e-5; linalg 1e-3); port against JAX the same
unless stated. Samplers differ by value between the packages (Philox
against threefry, C28's rule): they are held to their ranges and
moments, and to repeat under one seed.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import np, npx

jnp_ = jmx.np
jnpx = jmx.npx
RS = onp.random.RandomState(42)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield
    npx.reset_np()
    jnpx.reset_np()


def _rand(*shape, seed=None):
    rs = RS if seed is None else onp.random.RandomState(seed)
    return rs.randn(*shape).astype(onp.float32)


def _host(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _check(mx_out, onp_out, rtol=1e-5, atol=1e-5, jax_out=None):
    """The port's result against numpy's and, when given, the JAX
    package's (values and dtype)."""
    p = _host(mx_out)
    onp.testing.assert_allclose(p, onp_out, rtol=rtol, atol=atol)
    if jax_out is not None:
        j = _host(jax_out)
        assert p.dtype == j.dtype, (p.dtype, j.dtype)
        onp.testing.assert_allclose(p, j, rtol=rtol, atol=atol)


def _both(fn, *args, **kw):
    """``fn(np_module, *args)`` in the port and in the JAX package."""
    return fn(np, *args, **kw), fn(jnp_, *args, **kw)


# ------------------------------------------------------------- creation ----

def test_creation_functions():
    for m in (np, jnp_):
        assert m.ones((2, 3)).shape == (2, 3)
        assert m.zeros(4).shape == (4,)
        assert m.array(3.5).shape == ()
    for f, ref in (
            (lambda m: m.full((2, 2), 7.0), onp.full((2, 2), 7.0)),
            (lambda m: m.arange(10), onp.arange(10)),
            (lambda m: m.linspace(0, 1, 5),
             onp.linspace(0, 1, 5).astype("float32")),
            (lambda m: m.eye(3), onp.eye(3, dtype="float32")),
            (lambda m: m.zeros_like(m.array([[1, 2], [3, 4]],
                                            dtype="float32")),
             onp.zeros((2, 2), "float32")),
            (lambda m: m.ones_like(m.array([[1, 2], [3, 4]],
                                           dtype="float32")),
             onp.ones((2, 2), "float32"))):
        p, j = _both(f)
        _check(p, ref, jax_out=j)


UNARY_CASES = [
    ("absolute", onp.abs), ("sqrt", onp.sqrt), ("exp", onp.exp),
    ("log", onp.log), ("sin", onp.sin), ("cos", onp.cos),
    ("tanh", onp.tanh), ("floor", onp.floor), ("ceil", onp.ceil),
    ("square", onp.square), ("sign", onp.sign), ("log1p", onp.log1p),
    ("expm1", onp.expm1), ("arctan", onp.arctan), ("sinh", onp.sinh),
    ("cbrt", onp.cbrt), ("radians", onp.radians), ("degrees", onp.degrees),
]


@pytest.mark.parametrize("name,ofn", UNARY_CASES,
                         ids=[c[0] for c in UNARY_CASES])
def test_unary_oracle(name, ofn):
    x = onp.abs(_rand(3, 4, seed=1)) + 0.5
    p, j = _both(lambda m: getattr(m, name)(m.array(x)))
    _check(p, ofn(x), rtol=1e-4, jax_out=j)
    assert isinstance(p, np.ndarray)


BINARY_CASES = [
    ("add", onp.add), ("subtract", onp.subtract),
    ("multiply", onp.multiply), ("true_divide", onp.true_divide),
    ("power", onp.power), ("maximum", onp.maximum),
    ("minimum", onp.minimum), ("hypot", onp.hypot),
    ("arctan2", onp.arctan2), ("logaddexp", onp.logaddexp),
    ("fmod", onp.fmod), ("copysign", onp.copysign),
]


@pytest.mark.parametrize("name,ofn", BINARY_CASES,
                         ids=[c[0] for c in BINARY_CASES])
def test_binary_oracle(name, ofn):
    a = onp.abs(_rand(3, 4, seed=2)) + 0.5
    b = onp.abs(_rand(3, 4, seed=3)) + 0.5
    p, j = _both(lambda m: getattr(m, name)(m.array(a), m.array(b)))
    _check(p, ofn(a, b), rtol=1e-4, jax_out=j)


def test_broadcasting_and_scalars():
    a, b = _rand(3, 1, seed=4), _rand(1, 4, seed=5)
    for f, ref in ((lambda m: m.array(a) + m.array(b), a + b),
                   (lambda m: m.array(a) * 2.5, a * 2.5),
                   (lambda m: 3.0 - m.array(a), 3.0 - a),
                   (lambda m: 2.0 / m.array(onp.abs(a) + 1),
                    2.0 / (onp.abs(a) + 1))):
        p, j = _both(f)
        _check(p, ref, jax_out=j)


def test_comparisons_return_bool():
    for m in (np, jnp_):
        a = m.array([1.0, 2.0, 3.0])
        mk = a > 2.0
        assert onp.dtype(mk.dtype) == onp.bool_
        _check(mk.astype("float32"), onp.array([0.0, 0.0, 1.0]))
        assert bool((m.array([1.0]) == m.array([1.0])).item())


def test_boolean_indexing():
    x = _rand(4, 5, seed=6)
    idx = onp.array([2, 0, 3])
    for m in (np, jnp_):
        a = m.array(x)
        _check(a[a > 0], x[x > 0])
        _check(a[m.array(idx, dtype="int32")], x[idx])
    # newaxis, zero-dim and mixed keys
    a = np.array(x)
    assert a[1, 2].shape == () and a[None].shape == (1, 4, 5)
    _check(a[:, np.newaxis, 1:3], x[:, None, 1:3])
    # assignment through a mask keeps the shape and writes in place
    y = np.array(x)
    y[y > 0] = 0.0
    _check(y, onp.where(x > 0, 0.0, x))


REDUCE_CASES = [
    ("sum", onp.sum), ("mean", onp.mean), ("prod", onp.prod),
    ("max", onp.max), ("min", onp.min), ("std", onp.std), ("var", onp.var),
]


@pytest.mark.parametrize("name,ofn", REDUCE_CASES,
                         ids=[c[0] for c in REDUCE_CASES])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_reductions_oracle(name, ofn, axis):
    x = _rand(3, 4, seed=7)
    p, j = _both(lambda m: getattr(m, name)(m.array(x), axis=axis))
    _check(p, ofn(x, axis=axis), rtol=1e-4, jax_out=j)


def test_argmax_sort_cumsum():
    x = _rand(4, 5, seed=8)
    for f, ref in ((lambda m: m.argmax(m.array(x), axis=1),
                    onp.argmax(x, axis=1)),
                   (lambda m: m.argmin(m.array(x), axis=0),
                    onp.argmin(x, axis=0)),
                   (lambda m: m.sort(m.array(x), axis=1),
                    onp.sort(x, axis=1)),
                   (lambda m: m.argsort(m.array(x), axis=1),
                    onp.argsort(x, axis=1)),
                   (lambda m: m.cumsum(m.array(x), axis=0),
                    onp.cumsum(x, axis=0))):
        p, j = _both(f)
        _check(p, ref, rtol=1e-4, jax_out=j)


def test_shape_manipulation():
    x = _rand(2, 3, 4, seed=9)
    for f, ref in (
            (lambda m: m.array(x).reshape(6, 4), x.reshape(6, 4)),
            (lambda m: m.array(x).T, x.T),
            (lambda m: m.transpose(m.array(x), (2, 0, 1)),
             onp.transpose(x, (2, 0, 1))),
            (lambda m: m.swapaxes(m.array(x), 0, 2), onp.swapaxes(x, 0, 2)),
            (lambda m: m.expand_dims(m.array(x), 1), onp.expand_dims(x, 1)),
            (lambda m: m.squeeze(m.ones((1, 3, 1))), onp.ones(3, "float32")),
            (lambda m: m.broadcast_to(m.ones((1, 3)), (4, 3)),
             onp.ones((4, 3), "float32")),
            (lambda m: m.tile(m.array(x), (2, 1, 1)), onp.tile(x, (2, 1, 1))),
            (lambda m: m.repeat(m.array(x), 2, axis=1),
             onp.repeat(x, 2, axis=1)),
            (lambda m: m.flip(m.array(x), axis=0), onp.flip(x, axis=0)),
            (lambda m: m.roll(m.array(x), 1, axis=2),
             onp.roll(x, 1, axis=2))):
        p, j = _both(f)
        _check(p, ref, jax_out=j)


def test_concatenate_stack_split():
    x, y = _rand(2, 3, seed=10), _rand(2, 3, seed=11)
    for f, ref in (
            (lambda m: m.concatenate([m.array(x), m.array(y)], axis=0),
             onp.concatenate([x, y], axis=0)),
            (lambda m: m.stack([m.array(x), m.array(y)], axis=1),
             onp.stack([x, y], axis=1)),
            (lambda m: m.vstack([m.array(x), m.array(y)]), onp.vstack([x, y])),
            (lambda m: m.hstack([m.array(x), m.array(y)]),
             onp.hstack([x, y]))):
        p, j = _both(f)
        _check(p, ref, jax_out=j)
    parts, jparts = _both(lambda m: m.split(m.array(x), 3, axis=1))
    assert len(parts) == len(jparts) == 3
    for p, j, o in zip(parts, jparts, onp.split(x, 3, axis=1)):
        _check(p, o, jax_out=j)


def test_where_take_clip():
    x = _rand(3, 4, seed=12)
    idx = onp.array([0, 2])
    for f, ref in (
            (lambda m: m.where(m.array(x) > 0, m.array(x),
                               m.zeros_like(m.array(x))),
             onp.where(x > 0, x, 0)),
            (lambda m: m.clip(m.array(x), -0.5, 0.5),
             onp.clip(x, -0.5, 0.5)),
            (lambda m: m.take(m.array(x), m.array(idx, "int32"), axis=1),
             onp.take(x, idx, axis=1))):
        p, j = _both(f)
        _check(p, ref, jax_out=j)


def test_einsum_oracle():
    a, b, c = _rand(3, 4, seed=13), _rand(4, 5, seed=14), \
        _rand(2, 3, 4, seed=15)
    eye = _rand(4, 4, seed=16) * 0 + onp.eye(4, dtype="float32")
    for f, ref in (
            (lambda m: m.einsum("ij,jk->ik", m.array(a), m.array(b)),
             onp.einsum("ij,jk->ik", a, b)),
            (lambda m: m.einsum("bij->bji", m.array(c)),
             onp.einsum("bij->bji", c)),
            (lambda m: m.einsum("ii->", m.array(eye)),
             onp.array(4.0, "float32"))):
        p, j = _both(f)
        _check(p, ref, rtol=1e-4, jax_out=j)


def test_tensordot_matmul_dot():
    a, b = _rand(3, 4, seed=17), _rand(4, 5, seed=18)
    t1, t2 = _rand(2, 3, 4, seed=19), _rand(4, 3, 2, seed=20)
    for f, ref in (
            (lambda m: m.tensordot(m.array(a), m.array(b), axes=1), a @ b),
            (lambda m: m.matmul(m.array(a), m.array(b)), a @ b),
            (lambda m: m.array(a) @ m.array(b), a @ b),
            (lambda m: m.dot(m.array(a), m.array(b)), onp.dot(a, b)),
            (lambda m: m.tensordot(m.array(t1), m.array(t2),
                                   axes=((1, 2), (1, 0))),
             onp.tensordot(t1, t2, axes=((1, 2), (1, 0))))):
        p, j = _both(f)
        _check(p, ref, rtol=1e-4, jax_out=j)


def test_linalg_oracle():
    a = _rand(4, 4, seed=21) + 4 * onp.eye(4, dtype="float32")
    b = _rand(4, 2, seed=22)
    spd = a @ a.T + onp.eye(4, dtype="float32")
    for f, ref, tol in (
            (lambda m: m.linalg.inv(m.array(a)), onp.linalg.inv(a), 1e-3),
            (lambda m: m.linalg.det(m.array(a)), onp.linalg.det(a), 1e-3),
            (lambda m: m.linalg.solve(m.array(a), m.array(b)),
             onp.linalg.solve(a, b), 1e-3),
            (lambda m: m.linalg.norm(m.array(a)), onp.linalg.norm(a), 1e-4)):
        p, j = _both(f)
        _check(p, ref, rtol=tol, atol=1e-4, jax_out=j)
    for m in (np, jnp_):
        sign, logdet = m.linalg.slogdet(m.array(a))
        osign, ologdet = onp.linalg.slogdet(a)
        assert float(sign.item()) == pytest.approx(float(osign))
        assert float(logdet.item()) == pytest.approx(float(ologdet),
                                                     rel=1e-3)
        q, r = m.linalg.qr(m.array(a))
        onp.testing.assert_allclose(q.asnumpy() @ r.asnumpy(), a, atol=1e-4)
        L = m.linalg.cholesky(m.array(spd))
        onp.testing.assert_allclose(L.asnumpy() @ L.asnumpy().T, spd,
                                    rtol=1e-3, atol=1e-3)
        w, v = m.linalg.eigh(m.array(spd))
        onp.testing.assert_allclose(onp.sort(w.asnumpy()),
                                    onp.sort(onp.linalg.eigvalsh(spd)),
                                    rtol=1e-3, atol=1e-3)
        u, s, vt = m.linalg.svd(m.array(a))
        onp.testing.assert_allclose(
            u.asnumpy() @ onp.diag(s.asnumpy()) @ vt.asnumpy(), a, atol=1e-3)


def test_random_sanity():
    """Ranges and moments as tests/test_numpy.py holds the JAX package's;
    one seed repeats the port's draws."""
    np.random.seed(7)
    arr = np.random.uniform(2.0, 3.0, size=(1000,)).asnumpy()
    assert arr.min() >= 2.0 and arr.max() <= 3.0
    assert abs(arr.mean() - 2.5) < 0.05
    n = np.random.normal(0.0, 1.0, size=(2000,)).asnumpy()
    assert abs(n.mean()) < 0.1 and abs(n.std() - 1.0) < 0.1
    r = np.random.randint(0, 10, size=(500,)).asnumpy()
    assert r.min() >= 0 and r.max() < 10
    np.random.seed(3)
    a1 = np.random.uniform(size=(5,)).asnumpy()
    np.random.seed(3)
    a2 = np.random.uniform(size=(5,)).asnumpy()
    onp.testing.assert_array_equal(a1, a2)
    assert np.random.choice(5, size=(3,)).shape == (3,)
    p = np.random.permutation(10).asnumpy()
    assert sorted(p.tolist()) == list(range(10))
    x = np.arange(10)
    np.random.shuffle(x)
    assert sorted(x.asnumpy().tolist()) == list(range(10))


def test_np_autograd():
    grads = []
    for m, pkg in ((np, mx), (jnp_, jmx)):
        w = m.array([1.0, 2.0, 3.0])
        w.attach_grad()
        with pkg.autograd.record():
            loss = m.sum(w * w + m.exp(w))
        loss.backward()
        assert isinstance(w.grad, m.ndarray)
        grads.append(w.grad.asnumpy())
    ref = 2 * onp.array([1, 2, 3]) + onp.exp([1, 2, 3])
    onp.testing.assert_allclose(grads[0], ref, rtol=1e-5)
    onp.testing.assert_allclose(grads[0], grads[1], rtol=1e-5)


def test_np_einsum_autograd():
    a0, b0 = _rand(3, 4, seed=23), _rand(4, 5, seed=24)
    grads = []
    for m, pkg in ((np, mx), (jnp_, jmx)):
        a, b = m.array(a0), m.array(b0)
        a.attach_grad()
        with pkg.autograd.record():
            out = m.einsum("ij,jk->ik", a, b).sum()
        out.backward()
        grads.append(a.grad.asnumpy())
    onp.testing.assert_allclose(grads[0],
                                b0.sum(axis=1)[None, :].repeat(3, 0),
                                rtol=1e-4)
    onp.testing.assert_allclose(grads[0], grads[1], rtol=1e-5)


def test_npx_nn_ops():
    x0, w0, b0 = _rand(2, 8, seed=25), _rand(4, 8, seed=26), \
        _rand(4, seed=27)
    e = onp.exp([1.0, 2.0, 3.0])
    for f, ref in (
            (lambda m, x: x.fully_connected(m.array(x0), m.array(w0),
                                            m.array(b0), num_hidden=4),
             x0 @ w0.T + b0),
            (lambda m, x: x.relu(m.array([-1.0, 1.0])),
             onp.array([0.0, 1.0])),
            (lambda m, x: x.softmax(m.array([[1.0, 2.0, 3.0]])),
             (e / e.sum())[None, :].astype("float32")),
            (lambda m, x: x.one_hot(m.array([0, 2], dtype="int32"), depth=3),
             onp.eye(3, dtype="float32")[[0, 2]])):
        p, j = f(np, npx), f(jnp_, jnpx)
        assert isinstance(p, np.ndarray)
        _check(p, ref, rtol=1e-4, jax_out=j)


def test_npx_set_np_roundtrip():
    for x in (npx, jnpx):
        assert not x.is_np_array()
        x.set_np()
        assert x.is_np_array() and x.is_np_shape()
        x.reset_np()
        assert not x.is_np_array()
    with pytest.raises(ValueError):
        npx.set_np(shape=False, array=True)


def test_np_save_load(tmp_path):
    """Both packages write the nd.save format: each loads the other's
    file as mx.np arrays."""
    pf, jf = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    npx.save(pf, {"a": np.ones((2, 2)), "b": np.arange(3)})
    jnpx.save(jf, {"a": jnp_.ones((2, 2)), "b": jnp_.arange(3)})
    for loaded in (npx.load(pf), npx.load(jf)):
        assert isinstance(loaded["a"], np.ndarray)
        _check(loaded["a"], onp.ones((2, 2), "float32"))
        _check(loaded["b"], onp.arange(3))
    _check(jnpx.load(pf)["a"], onp.ones((2, 2), "float32"))


def test_np_nd_interop():
    a = np.ones((2, 2))
    legacy = a.as_nd_ndarray()
    assert type(legacy).__name__ == "NDArray"
    back = np._as_np(legacy)
    assert isinstance(back, np.ndarray)
    assert isinstance(legacy.as_np_ndarray(), np.ndarray)
    # an op with an mx.np input returns mx.np, through the legacy ops too
    assert isinstance(mx.nd.relu(back), np.ndarray)
    assert type(mx.nd.relu(legacy)) is mx.nd.NDArray


def test_np_statistics():
    x = _rand(100, seed=28)
    for f, ref, tol in (
            (lambda m: m.median(m.array(x)), onp.median(x), 1e-5),
            (lambda m: m.percentile(m.array(x), 30.0),
             onp.percentile(x, 30.0).astype("float32"), 1e-3),
            (lambda m: m.diff(m.array(x)), onp.diff(x), 1e-4)):
        p, j = _both(f)
        _check(p, ref, rtol=tol, jax_out=j)
    (h, edges), (jh, jedges) = _both(lambda m: m.histogram(m.array(x),
                                                           bins=10))
    oh, oe = onp.histogram(x, bins=10)
    onp.testing.assert_array_equal(h.asnumpy(), oh)
    onp.testing.assert_array_equal(h.asnumpy(), jh.asnumpy())
    onp.testing.assert_allclose(edges.asnumpy(), jedges.asnumpy(),
                                rtol=1e-6)


def test_positional_args_bind_correctly():
    x = onp.array([[1.0, 2.0], [3.0, 4.0]], "float32")
    for f, ref in (
            (lambda m: m.tril(m.array(x), 1), onp.tril(x, 1)),
            (lambda m: m.tril(m.array(x), -1), onp.tril(x, -1)),
            (lambda m: m.triu(m.array(x), 1), onp.triu(x, 1)),
            (lambda m: m.cumsum(m.array(x), 1), onp.cumsum(x, 1)),
            (lambda m: m.diag(m.array([1.0, 2.0]), 1),
             onp.diag(onp.array([1.0, 2.0], "float32"), 1))):
        p, j = _both(f)
        _check(p, ref, jax_out=j)


def test_dynamic_shape_ops_eager():
    """The data-shaped ops are host ops in the port: each is noted by
    ``watching_host_ops`` (a body holding one runs uncaptured)."""
    x = onp.array([[0.0, 1.0], [2.0, 0.0]], "float32")
    with mx.operator.registry.watching_host_ops() if hasattr(
            mx.operator, "registry") else \
            mx.ops.registry.watching_host_ops() as seen:
        for m in (np, jnp_):
            a = m.array(x)
            rows, cols = m.nonzero(a)
            onp.testing.assert_array_equal(rows.asnumpy(), [0, 1])
            onp.testing.assert_array_equal(cols.asnumpy(), [1, 0])
            idx = m.where(a > 0)
            assert isinstance(idx, tuple) and len(idx) == 2
            u = m.unique(m.array([3, 1, 3, 2], dtype="int32"))
            onp.testing.assert_array_equal(u.asnumpy(), [1, 2, 3])
            bc = m.bincount(m.array([0, 1, 1, 3], dtype="int32"))
            onp.testing.assert_array_equal(bc.asnumpy(), [1, 2, 0, 1])
    assert {"_npi_nonzero", "_npi_unique", "_npi_bincount"} <= set(seen)


def test_np_gradient():
    x = onp.array([1.0, 2.0, 4.0, 7.0], "float32")
    p, j = _both(lambda m: m.gradient(m.array(x)))
    _check(p, onp.gradient(x), jax_out=j)


def test_result_type_no_transfer(monkeypatch):
    a = np.ones((2, 2))

    def no_read(*args, **kwargs):
        raise AssertionError("result_type read the array")

    monkeypatch.setattr(np.ndarray, "asnumpy", no_read)
    assert np.result_type(a, "float64") == onp.float64
    assert np.result_type(a, "float64") == \
        jnp_.result_type(jnp_.ones((2, 2)), "float64")


def test_np_frontend_tail():
    a4 = onp.random.RandomState(0).rand(4, 4).astype("f") + \
        onp.eye(4, dtype="f") * 3
    for f, ref, tol in (
            (lambda m: m.hanning(5), onp.hanning(5), 1e-6),
            (lambda m: m.hamming(4), onp.hamming(4), 1e-6),
            (lambda m: m.polyval(m.array([1., 2., 3.]), m.array([2.0])),
             [11.0], 1e-6),
            (lambda m: m.delete(m.array([1., 2., 3.]), 1), [1., 3.], 0),
            (lambda m: m.insert(m.array([1., 3.]), 1, 2.0), [1., 2., 3.], 0),
            (lambda m: m.ediff1d(m.array([1., 4., 9.])), [3., 5.], 0),
            (lambda m: m.deg2rad(m.array([180.0])), [onp.pi], 1e-6),
            (lambda m: m.rad2deg(m.array([onp.pi])), [180.0], 1e-6),
            (lambda m: m.around(m.array([1.256]), decimals=1), [1.3], 1e-5),
            (lambda m: m.linalg.pinv(m.array(a4)), onp.linalg.pinv(a4),
             1e-4)):
        p, j = _both(f)
        _check(p, onp.asarray(ref, dtype=onp.float32), rtol=tol,
               atol=max(tol, 1e-6), jax_out=j)
    for m in (np, jnp_):
        assert m.dsplit(m.ones((2, 2, 4)), 2)[0].shape == (2, 2, 2)
    mx.random.seed(0)
    assert np.random.pareto(2.0, size=(3,)).shape == (3,)
    assert np.random.weibull(2.0, size=(3,)).shape == (3,)
    assert np.random.rayleigh(1.0, size=(3,)).shape == (3,)
    for m in (np, jnp_):
        assert m.random.multinomial(
            7, [0.0, 1.0, 0.0]).asnumpy().tolist() == [0, 7, 0]


def test_numpy_dispatch_protocol():
    """numpy functions on mx.np arrays return mx.np arrays, through the
    mx function where there is one and numpy's on host copies
    otherwise; each fallback is counted."""
    for m in (np, jnp_):
        a = m.array([[1.0, 2.0], [3.0, 4.0]])
        mean = onp.mean(a)
        assert isinstance(mean, type(a)) and float(mean.asnumpy()) == 2.5
        s = onp.add(a, 1)
        assert isinstance(s, type(a))
        onp.testing.assert_allclose(s.asnumpy(), a.asnumpy() + 1)
        c = onp.concatenate([a, a])
        assert isinstance(c, type(a)) and c.shape == (4, 2)
        d = onp.dot(a, a)
        assert isinstance(d, type(a))
        onp.testing.assert_allclose(d.asnumpy(), a.asnumpy() @ a.asnumpy())
        sq = onp.sqrt(a)
        assert isinstance(sq, type(a))
        onp.testing.assert_allclose(sq.asnumpy(), onp.sqrt(a.asnumpy()))
        w = onp.where(a > 2, a, 0 * a)
        assert isinstance(w, type(a))
    a = np.array([[1.0, 2.0], [3.0, 4.0]])
    with np.watching_fallbacks() as seen:
        onp.mean(a)
        onp.add.reduce(a)
        onp.linalg.matrix_rank(a)
    assert seen == ["reduce", "matrix_rank"]


def test_numpy_dispatch_out_where_inplace():
    for m in (np, jnp_):
        a = m.array([[1.0, 2.0], [3.0, 4.0]])
        b = m.array([[10.0, 10.0], [10.0, 10.0]])
        c = m.zeros((2, 2))
        r = onp.add(a, b, out=c)
        assert r is c
        onp.testing.assert_allclose(c.asnumpy(), a.asnumpy() + 10)
        mm = onp.add(a, b, where=onp.array([[True, False], [False, True]]),
                     out=m.zeros((2, 2)))
        assert mm.asnumpy().tolist() == [[11.0, 0.0], [0.0, 14.0]]
        d = onp.multiply(a, b, dtype=onp.float64)
        onp.testing.assert_allclose(d.asnumpy(), a.asnumpy() * 10)
        e = m.array([1.0, 2.0, 3.0])
        raw_before = e._data
        onp.add.at(e, [0, 1], 5.0)
        assert e.asnumpy().tolist() == [6.0, 7.0, 3.0]
        assert raw_before is not e._data
        assert onp.add.reduce(a).asnumpy().tolist() == [4.0, 6.0]
        co = m.zeros((4, 2))
        r = onp.concatenate([a, a], out=co)
        assert r is co
        onp.testing.assert_allclose(co.asnumpy()[:2], a.asnumpy())


# --------------------------------------------- dtypes against the JAX ops ---

_I = onp.array([1, 2, 3], onp.int32)
_B = onp.array([True, False, True])
_F = onp.array([1.0, 2.0, 3.0], onp.float32)
_T = onp.array([True, True, True])   # a bool divisor with no zero
_DIVIDING = {"floor_divide", "mod", "fmod", "remainder", "rtrue_divide",
             "rmod", "rfloor_divide"}


def _op_dtypes(name, pairs, **kw):
    """``{tag: (port dtype, JAX dtype)}`` of op ``name`` on each input
    tuple; an op that raises in the JAX package is skipped."""
    from mxnet_tpu.ops import registry as jreg
    import jax.numpy as jnp

    out = {}
    kw = jreg.get(name).check_kwargs(kw)   # as the JAX _invoke does
    for tag, arrays in pairs:
        try:
            j = jreg.get(name).fn(*[jnp.asarray(a) for a in arrays], **kw)
        except (TypeError, ValueError):
            continue
        p = mx.nd.invoke(name, *[mx.nd.array(a) for a in arrays], **kw)
        out[tag] = (onp.dtype(str(p.dtype).replace("torch.", "")),
                    onp.dtype(j.dtype))
        if onp.issubdtype(out[tag][1], onp.floating):
            onp.testing.assert_allclose(p.asnumpy(), onp.asarray(j),
                                        rtol=1e-5, atol=1e-6,
                                        err_msg=f"{name} {tag}")
        else:
            onp.testing.assert_array_equal(p.asnumpy(), onp.asarray(j),
                                           err_msg=f"{name} {tag}")
    return out


_UNARY = ["negative", "reciprocal", "absolute", "sign", "rint", "ceil",
          "floor", "trunc", "fix", "square", "sqrt", "cbrt", "exp", "expm1",
          "log", "log10", "log2", "log1p", "sin", "cos", "tan", "arcsin",
          "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh",
          "arctanh", "degrees", "radians", "invert", "logical_not",
          "isnan", "isinf", "isposinf", "isneginf", "isfinite", "conj",
          "real", "imag"]
_BINARY = ["add", "subtract", "multiply", "true_divide", "floor_divide",
           "mod", "fmod", "remainder", "power", "maximum", "minimum", "fmax",
           "fmin", "hypot", "arctan2", "copysign", "ldexp", "logaddexp",
           "bitwise_and", "bitwise_or", "bitwise_xor", "left_shift",
           "right_shift", "logical_and", "logical_or", "logical_xor",
           "equal", "not_equal", "less", "less_equal", "greater",
           "greater_equal", "matmul", "dot", "inner", "outer", "kron",
           "gcd", "lcm"]
_REDUCE = ["sum", "prod", "mean", "std", "var", "max", "min", "argmax",
           "any", "all", "cumsum", "cumprod", "nansum", "nanprod", "median",
           "average", "ptp", "count_nonzero"]
_SCALAR = ["add", "subtract", "rsubtract", "multiply", "true_divide",
           "rtrue_divide", "mod", "rmod", "power", "rpower", "floor_divide",
           "rfloor_divide"]


@pytest.mark.parametrize("kind", ["unary", "binary", "reduce", "scalar"])
def test_dtype_promotion_matches_the_jax_ops(kind):
    """Each op's result dtype and values on int32, bool and float32
    inputs (and mixes) are the JAX op's, with 64-bit types off."""
    with mx.cpu():
        if kind == "unary":
            cases = [(n, [("i", (_I,)), ("b", (_B,)), ("f", (_F + 0.5,))],
                      {}) for n in _UNARY]
        elif kind == "reduce":
            cases = [(n, [("i", (_I,)), ("b", (_B,)), ("f", (_F,))], {})
                     for n in _REDUCE]
        elif kind == "binary":
            cases = []
            for n in _BINARY:
                b = _T if n in _DIVIDING else _B
                cases.append((n, [("ii", (_I, _I)), ("bb", (b, b)),
                                  ("if", (_I, _F)), ("ib", (_I, b)),
                                  ("fb", (_F, b))], {}))
        else:
            cases = []
            for n in _SCALAR:
                b = _T if n in _DIVIDING else _B
                for s in (2, 2.5):
                    cases.append((f"{n}_scalar", [("i", (_I,)), ("b", (b,)),
                                                  ("f", (_F,))],
                                  {"scalar": s}))
        seen = 0
        for name, pairs, kw in cases:
            for tag, (p, j) in _op_dtypes(f"_npi_{name}", pairs,
                                          **kw).items():
                assert p == j, (name, tag, kw, p, j)
                seen += 1
        assert seen >= len(cases)


# ------------------------------------------- np_surface's cases vs JAX ------

def _jax_case(case, seed):
    """The JAX op's outputs of one of chip_smoke.np_cases() (numpy
    arrays, in the case's invariant form)."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg

    from chip_smoke import np_case_inputs, np_case_invariant

    name, specs, kw = case[:3]
    kw = dict(kw)
    if case[3] == "sampler":
        kw["key"] = jax.random.PRNGKey(seed)
    if "pvals" in kw:
        kw["pvals"] = jnp.asarray(kw["pvals"], jnp.float32)
    op = jreg.get(name)
    kw = {k: v for k, v in op.check_kwargs(kw).items()}
    out = op.fn(*[jnp.asarray(a) for a in np_case_inputs(specs, seed)],
                **kw)
    outs = tuple(onp.asarray(o) for o in (out if isinstance(out, (tuple,
                                                                  list))
                                          else (out,)))
    return np_case_invariant(case[4], outs) if len(case) > 4 else outs


# where the JAX op and the port differ by design, the case's outputs are
# held to numpy's instead: jnp.unique/nonzero need static sizes under the
# JAX op's own jit only; _npi_share_memory reads the storage, the JAX op
# is always False (a copy in each case here: both False)
_NP_CASE_JAX_TOL = {"exact": (0, 0), "ulp": (2e-6, 1e-6),
                    "reduce": (1e-5, 1e-5), "linalg": (1e-4, 1e-4)}


@pytest.mark.parametrize("family", ["exact", "ulp", "reduce", "linalg",
                                    "sampler"])
def test_np_surface_cases_match_the_jax_ops(family):
    """Every case of chip_smoke.np_cases() (one or more per NumPy-frontend
    op name) through the port on the CPU against the JAX op on the same
    inputs: equal shapes and dtypes, values within the family's
    tolerance (samplers by shape and dtype: Philox against threefry)."""
    from chip_smoke import np_cases, np_run_case

    bad = []
    for i, case in enumerate(np_cases()):
        if case[3] != family:
            continue
        port = np_run_case(case, mx.cpu(), i)
        ref = _jax_case(case, i)
        rtol, atol = _NP_CASE_JAX_TOL.get(family, (0, 0))
        for p, j in zip(port, ref):
            j = onp.asarray(j)
            if p.shape != j.shape or p.dtype != j.dtype:
                bad.append((case[0], "shape/dtype", p.shape, p.dtype,
                            j.shape, j.dtype))
            elif family != "sampler" and not onp.allclose(
                    p, j, rtol=rtol, atol=atol, equal_nan=True):
                bad.append((case[0], "values",
                            float(onp.abs(p.astype(onp.float64) - j).max())))
        if len(port) != len(ref):
            bad.append((case[0], "outputs", len(port), len(ref)))
    assert not bad, bad


def test_np_surface_cases_reach_every_name():
    """The cases reach each of the 271 names ops/numpy_ops.py registers
    (np_surface prints the names none reaches; here there are none)."""
    from chip_smoke import np_cases
    from mxnet_tpu_torch.ops import registry

    names = {n for n in registry.list_ops()
             if n.startswith(("_np_", "_npi_", "_npx_"))} | {
        "_split_v2", "_unravel_index", "_ravel_multi_index"}
    assert len(names) == 271
    assert sorted(names - {c[0] for c in np_cases()}) == []
