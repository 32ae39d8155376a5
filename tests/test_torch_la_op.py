"""The linear-algebra ops (``ops/la_op.py``, and ``tensor.py``'s
``linalg_gemm2``, ``linalg_potrf``, ``linalg_syrk`` and ``khatri_rao``) in
the port against the JAX package, on the CPU: values and, through
``torch.autograd`` against ``jax.vjp``, gradients, from the same numpy
inputs (seeded) and cotangents.

QR and eigenvector signs differ between solvers (LAPACK through torch,
XLA here), so ``gelqf`` and ``syevd`` are held sign-normalised (each of
``gelqf``'s rows signed by ``L``'s diagonal, each eigenvector by its
largest component), by their reconstructions and orthonormality, and
their gradients through heads that do not see the signs (squares of the
factors' entries). ``gelqf`` returns ``(Q, L)`` in the port, as MXNet
1.x does, and ``(L, Q)`` in the JAX package (fault C23, kept in the
reference). A matrix that is not positive definite gives ``linalg_potrf``
NaN in its lower triangle in both packages; the port's factor comes from
``cholesky_ex``, which reads no status back to the host.

Tolerances: float32 values at rtol 1e-4, atol 1e-5; gradients at rtol
1e-3, atol 1e-4 (solves and eigendecompositions of 5 x 5 matrices with
condition numbers below 100, in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx  # noqa: F401  (registers the JAX ops)
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as reg

VAL = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)


def _rs(seed):
    return np.random.RandomState(seed)


def _spd(seed, b=2, n=5):
    m = _rs(seed).randn(b, n, n)
    return (m @ m.transpose(0, 2, 1) / n + np.eye(n)).astype(np.float32)


def _tri(seed, b=2, n=5, lower=True):
    a = _rs(seed).randn(b, n, n) * 0.3 + 2 * np.eye(n)
    return (np.tril(a) if lower else np.triu(a)).astype(np.float32)


def _mat(seed, *shape):
    return _rs(seed).randn(*shape).astype(np.float32)


# name, inputs, kwargs
CASES = [
    ("linalg_gemm", lambda: [_mat(1, 2, 4, 3), _mat(2, 2, 3, 5),
                             _mat(3, 2, 4, 5)], dict(alpha=0.5, beta=2.0)),
    ("linalg_gemm", lambda: [_mat(1, 2, 3, 4), _mat(2, 2, 5, 3),
                             _mat(3, 2, 4, 5)],
     dict(transpose_a=True, transpose_b=True)),
    ("linalg_gemm2", lambda: [_mat(4, 2, 4, 3), _mat(5, 2, 4, 6)],
     dict(transpose_a=True, alpha=2.0)),
    ("linalg_potrf", lambda: [_spd(6)], {}),
    ("linalg_potri", lambda: [_tri(7)], {}),
    ("linalg_potri", lambda: [_tri(7, lower=False)], dict(lower=False)),
    ("linalg_trmm", lambda: [_tri(8), _mat(9, 2, 5, 3)], dict(alpha=1.5)),
    ("linalg_trmm", lambda: [_tri(8, lower=False), _mat(9, 2, 3, 5)],
     dict(rightside=True, transpose=True, lower=False)),
    ("linalg_trsm", lambda: [_tri(10), _mat(11, 2, 5, 3)], dict(alpha=2.0)),
    ("linalg_trsm", lambda: [_tri(10), _mat(11, 2, 5, 3)],
     dict(transpose=True)),
    ("linalg_trsm", lambda: [_tri(10, lower=False), _mat(11, 2, 3, 5)],
     dict(rightside=True, lower=False)),
    ("linalg_trsm", lambda: [_tri(10), _mat(11, 2, 3, 5)],
     dict(rightside=True, transpose=True, alpha=0.5)),
    ("linalg_syrk", lambda: [_mat(12, 2, 4, 6)], dict(alpha=0.5)),
    ("linalg_syrk", lambda: [_mat(12, 2, 4, 6)], dict(transpose=True)),
    ("linalg_sumlogdiag", lambda: [_spd(13)], {}),
    ("linalg_extractdiag", lambda: [_mat(14, 2, 5, 5)], {}),
    ("linalg_extractdiag", lambda: [_mat(14, 2, 5, 5)], dict(offset=2)),
    ("linalg_extractdiag", lambda: [_mat(14, 2, 5, 5)], dict(offset=-1)),
    ("linalg_makediag", lambda: [_mat(15, 2, 4)], {}),
    ("linalg_makediag", lambda: [_mat(15, 2, 4)], dict(offset=1)),
    ("linalg_makediag", lambda: [_mat(15, 2, 4)], dict(offset=-2)),
    ("linalg_extracttrian", lambda: [_mat(16, 2, 5, 5)], {}),
    ("linalg_extracttrian", lambda: [_mat(16, 2, 5, 5)], dict(offset=1)),
    ("linalg_extracttrian", lambda: [_mat(16, 2, 5, 5)],
     dict(offset=-2, lower=True)),
    ("linalg_extracttrian", lambda: [_mat(16, 2, 5, 5)], dict(lower=False)),
    ("linalg_maketrian", lambda: [_mat(17, 2, 10)], {}),
    ("linalg_maketrian", lambda: [_mat(17, 2, 10)], dict(lower=False)),
    ("linalg_maketrian", lambda: [_mat(17, 2, 6)], dict(offset=1)),
    ("linalg_maketrian", lambda: [_mat(17, 2, 6)], dict(offset=-2)),
    ("linalg_det", lambda: [_mat(18, 3, 4, 4)
                            + 3 * np.eye(4, dtype=np.float32)], {}),
    ("linalg_slogdet", lambda: [_mat(19, 3, 4, 4)], {}),
    ("linalg_inverse", lambda: [_mat(20, 3, 4, 4)
                                + 3 * np.eye(4, dtype=np.float32)], {}),
    ("khatri_rao", lambda: [_mat(21, 3, 4), _mat(22, 2, 4), _mat(23, 5, 4)],
     {}),
]


def _ids():
    return [f"{n}-{i}" for i, (n, _, _) in enumerate(CASES)]


def _port(name, arrays, kw, cots=None):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = reg.get(name)(*ts, **kw)
    outs = list(out) if isinstance(out, tuple) else [out]
    grads = None
    if cots is not None:
        pairs = [(o, torch.tensor(c)) for o, c in zip(outs, cots)
                 if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs], ts,
                                    [c for _, c in pairs], allow_unused=True)
        grads = [np.zeros_like(a) if g is None else g.numpy()
                 for a, g in zip(arrays, grads)]
    return [o.detach().numpy() for o in outs], grads


def _jax(name, arrays, kw, cots=None):
    fn = jreg.get(name).fn
    outs, pull = jax.vjp(lambda *xs: fn(*xs, **kw),
                         *[jnp.asarray(a) for a in arrays])
    single = not isinstance(outs, (tuple, list))
    outs = [outs] if single else list(outs)
    grads = None
    if cots is not None:
        ct = [jnp.asarray(c).astype(o.dtype) for c, o in zip(cots, outs)]
        grads = [np.asarray(g) for g in pull(ct[0] if single else tuple(ct))]
    return [np.asarray(o) for o in outs], grads


@pytest.mark.parametrize("case", range(len(CASES)), ids=_ids())
def test_value_and_gradient_match_jax(case):
    name, make, kw = CASES[case]
    arrays = make()
    want, _ = _jax(name, arrays, kw)
    got, _ = _port(name, arrays, kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **VAL)
    rs = _rs(100 + case)
    cots = [rs.randn(*w.shape).astype(np.float32) for w in want]
    _, jg = _jax(name, arrays, kw, cots)
    _, pg = _port(name, arrays, kw, cots)
    for g, w in zip(pg, jg):
        np.testing.assert_allclose(g, w, **GRAD)


def _lq_signed(q, low):
    s = np.sign(np.diagonal(low, axis1=-2, axis2=-1))[..., None]
    return q * s, low * np.swapaxes(s, -1, -2)


@pytest.mark.parametrize("shape", [(2, 3, 5), (4, 4)])
def test_gelqf_is_mxnets_q_then_l_and_matches_jax_signed(shape):
    a = _mat(30, *shape)
    (q, low), _ = _port("linalg_gelqf", [a], {})
    (jl, jq), _ = _jax("linalg_gelqf", [a], {})   # C23: (L, Q) there
    np.testing.assert_allclose(low @ q, a, **VAL)
    m = shape[-2]
    np.testing.assert_allclose(q @ np.swapaxes(q, -1, -2),
                               np.broadcast_to(np.eye(m), q.shape[:-2]
                                               + (m, m)), atol=1e-5)
    assert np.allclose(np.triu(low, 1), 0)
    for g, w in zip(_lq_signed(q, low), _lq_signed(jq, jl)):
        np.testing.assert_allclose(g, w, **VAL)
    # the gradient through a head the signs do not reach
    rs = _rs(31)
    c1, c2 = rs.randn(*q.shape), rs.randn(*low.shape)
    t = torch.tensor(a, requires_grad=True)
    pq, pl = reg.get("linalg_gelqf")(t)
    ((pq * pq * torch.tensor(c1)).sum()
     + (pl * pl * torch.tensor(c2)).sum()).backward()
    jgrad = jax.grad(lambda x: (lambda lq: jnp.sum(lq[1] ** 2 * c1)
                                + jnp.sum(lq[0] ** 2 * c2))(
        jreg.get("linalg_gelqf").fn(x)))(jnp.asarray(a))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), **GRAD)


def test_syevd_rows_are_eigenvectors_ascending_and_match_jax_signed():
    a = _spd(32, b=3, n=6)
    (u, lam), _ = _port("linalg_syevd", [a], {})
    (ju, jlam), _ = _jax("linalg_syevd", [a], {})
    np.testing.assert_allclose(lam, jlam, **VAL)
    assert (np.diff(lam, axis=-1) > 0).all()
    np.testing.assert_allclose(
        np.swapaxes(u, -1, -2) @ (lam[..., None] * u), a, rtol=1e-4,
        atol=1e-4)

    def signed(v):
        big = np.take_along_axis(v, np.abs(v).argmax(-1)[..., None], -1)
        return v * np.sign(big)

    np.testing.assert_allclose(signed(u), signed(ju), rtol=1e-3, atol=1e-4)
    rs = _rs(33)
    c1, c2 = rs.randn(*u.shape), rs.randn(*lam.shape)
    t = torch.tensor(a, requires_grad=True)
    pu, pl = reg.get("linalg_syevd")(t)
    ((pu * pu * torch.tensor(c1)).sum()
     + (pl * torch.tensor(c2)).sum()).backward()
    jgrad = jax.grad(lambda x: (lambda ul: jnp.sum(ul[0] ** 2 * c1)
                                + jnp.sum(ul[1] * c2))(
        jreg.get("linalg_syevd").fn(x)))(jnp.asarray(a))
    # both symmetric in the input's two triangles only through their sum
    sym = lambda g: g + np.swapaxes(g, -1, -2)  # noqa: E731
    np.testing.assert_allclose(sym(t.grad.numpy()), sym(np.asarray(jgrad)),
                               rtol=1e-3, atol=1e-3)


def test_potrf_of_a_matrix_not_positive_definite_is_nan_as_in_jax():
    a = _spd(34, b=3)
    a[1] = -a[1]
    got, _ = _port("linalg_potrf", [a], {})
    want, _ = _jax("linalg_potrf", [a], {})
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(want[0]))
    assert np.isnan(got[0][1][np.tril_indices(5)]).all()
    np.testing.assert_allclose(got[0][[0, 2]], want[0][[0, 2]], **VAL)


def test_every_linalg_name_and_alias_is_the_jax_packages():
    def names(r):
        return sorted(n for n in r.list_ops()
                      if "linalg_" in n or n == "khatri_rao")

    got, want = names(reg), names(jreg)
    assert got == want
    assert len(got) == 35   # 17 linalg ops, their 17 aliases, khatri_rao
    for n in got:
        if n.startswith("_linalg_"):
            assert reg.num_outputs(n) == reg.num_outputs(n[1:])


def test_nd_and_sym_reach_the_ops():
    a = _spd(35)
    with mx.cpu():
        low = mx.nd.linalg_potrf(mx.nd.array(a))
        inv = mx.nd._linalg_potri(low)
        np.testing.assert_allclose(inv.asnumpy(), np.linalg.inv(a),
                                   rtol=1e-3, atol=1e-4)
        q, l_ = mx.nd.linalg_gelqf(mx.nd.array(a))
        x = mx.sym.var("x")
        s = mx.sym.linalg_syrk(mx.sym.linalg_potrf(x))
        assert s.infer_shape(x=(2, 5, 5))[1] == [(2, 5, 5)]
        np.testing.assert_allclose(s.eval(x=mx.nd.array(a))[0].asnumpy(), a,
                                   rtol=1e-4, atol=1e-4)
        back = mx.sym.load_json(s.tojson())
        assert back.tojson() == s.tojson()


def test_syevd_is_a_host_op_and_a_hybridized_block_holding_it_runs_uncaptured():
    """``linalg_syevd`` syncs with the host on a card (cuSOLVER's status
    read back), so it is a host op: the compile service runs a body
    holding it uncaptured, counted under its reason, from the first call
    on; a body of the other ops stays a plain entry."""
    from mxnet_tpu_torch import compile as mxc

    class Eig(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.linalg_syevd(x)[1] * 2

    class Inv(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.linalg_inverse(F.linalg_potri(F.linalg_potrf(x)))

    a = _spd(36, b=2)
    mxc.reset_stats()
    with mx.cpu(), reg.watching_host_ops() as seen:
        eig, inv = Eig(), Inv()
        eig.hybridize()
        inv.hybridize()
        for _ in range(3):
            lam = eig(mx.nd.array(a)).asnumpy()
            back = inv(mx.nd.array(a)).asnumpy()
    assert seen == ["linalg_syevd"]
    st = mxc.stats()["cachedop"]
    assert st["uncaptured"] == {"host op linalg_syevd": 3}
    np.testing.assert_allclose(lam, 2 * np.linalg.eigvalsh(a), **VAL)
    np.testing.assert_allclose(back, a, rtol=1e-3, atol=1e-3)
