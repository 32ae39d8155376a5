"""``mx.nd.contrib``'s control flow (``foreach``, ``while_loop``,
``cond``) and float checks in the port against the JAX package on the
CPU, eagerly (not recording, and under ``autograd.record()``) and inside
a hybridized block (the JAX package's ``lax.scan``/``lax.cond`` trace;
the port's compile-service body), forward and gradient, from the same
seeded numpy inputs.

``while_loop`` stops before ``max_iterations``, so its outputs carry zero
rows past the stop. ``cond`` is held in both directions and with an
untaken branch that is NaN (``sqrt`` of negative numbers): its gradient
must stay finite where the JAX one (``lax.cond``) is. Tolerances: float32
at rtol 1e-5, atol 1e-6.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import compile as mxc

TOL = dict(rtol=1e-5, atol=1e-6)
MODES = ["eager", "record", "hybrid", "hybrid_record"]


def _inputs(seed, shape=(4, 3), negative=False):
    rs = np.random.RandomState(seed)
    x = rs.uniform(0.2, 1.5, shape).astype(np.float32)
    w = rs.uniform(0.5, 1.5, shape[1:]).astype(np.float32)
    return (-x if negative else x), w


def _foreach(m, x, w):
    def body(xi, states):
        s = states[0]
        out = xi * s + w
        return out, [s * 0.5 + m.nd.sum(xi)]

    first = m.nd.sum(x, axis=0)
    outs, states = m.nd.contrib.foreach(body, x, [m.nd.ones_like(first)])
    return m.nd.sum(outs * outs) + m.nd.sum(states[0])


def _while(m, x, w, stop=3, iters=6):
    def cond(i, s):
        return i < stop

    def func(i, s):
        return [s * m.nd.sum(x, axis=0) + w, i * 2], \
            [i + 1, s + m.nd.sum(x) * 0.1]

    i0 = m.nd.zeros((1,), ctx=_ctx(m))
    s0 = m.nd.ones((1,), ctx=_ctx(m))
    outs, (i, s) = m.nd.contrib.while_loop(cond, func, [i0, s0],
                                           max_iterations=iters)
    return m.nd.sum(outs[0] * outs[0]) + m.nd.sum(outs[1]) + \
        m.nd.sum(s) * 3 + m.nd.sum(i), outs


def _cond(m, x, w):
    return m.nd.contrib.cond(
        m.nd.sum(x) < 0, lambda: m.nd.sum(x * w * 2),
        lambda: m.nd.sum(m.nd.sqrt(x) * w))


def _ctx(m):
    return mx.cpu() if m is mx else jmx.cpu()


def _run(m, fn, x_np, w_np, mode):
    """``fn``'s scalar result and the gradients of ``x`` and ``w`` (when
    recorded), in ``mode``."""
    with _ctx(m):
        x = m.nd.array(x_np)
        w = m.nd.array(w_np)
        if mode.startswith("hybrid"):
            class Net(m.gluon.HybridBlock):
                def hybrid_forward(self, F, a, b):
                    out = fn(m, a, b)
                    return out[0] if isinstance(out, tuple) else out

            net = Net()
            net.hybridize()
            call = net
        else:
            def call(a, b):
                out = fn(m, a, b)
                return out[0] if isinstance(out, tuple) else out
        if not mode.endswith("record"):
            return float(call(x, w).asnumpy().reshape(-1)[0]), None
        x.attach_grad()
        w.attach_grad()
        with m.autograd.record():
            y = call(x, w)
        y.backward()
        return float(y.asnumpy().reshape(-1)[0]), \
            [x.grad.asnumpy(), w.grad.asnumpy()]


def _held(fn, x, w, mode):
    want, jg = _run(jmx, fn, x, w, mode)
    got, pg = _run(mx, fn, x, w, mode)
    np.testing.assert_allclose(got, want, **TOL)
    if jg is not None:
        for g, j in zip(pg, jg):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, j, **TOL)
    return got, pg


@pytest.mark.parametrize("mode", MODES)
def test_foreach_matches_jax(mode):
    _held(_foreach, *_inputs(0), mode)


@pytest.mark.parametrize("mode", MODES)
def test_while_loop_matches_jax_and_pads_past_the_stop(mode):
    _held(_while, *_inputs(1), mode)


def test_while_loop_rows_past_the_stop_are_zero_in_both_forms():
    """The host loop (recording, outside a compiled body) and the masked
    form (anywhere else) give the same rows: three steps, then zeros."""
    x, w = _inputs(2)
    with mx.cpu():
        xs, ws = mx.nd.array(x), mx.nd.array(w)
        _, masked = _while(mx, xs, ws)
        with mx.autograd.record():
            _, host = _while(mx, xs, ws)
    for a, b in zip(masked, host):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)
    rows = masked[0].asnumpy()
    assert rows.shape == (6, 3)
    assert np.abs(rows[:3]).min() > 0 and not rows[3:].any()
    np.testing.assert_array_equal(masked[1].asnumpy().ravel(),
                                  [0, 2, 4, 0, 0, 0])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("negative", [False, True])
def test_cond_matches_jax_both_ways(mode, negative):
    _held(_cond, *_inputs(3, negative=negative), mode)


def test_cond_gradient_is_finite_where_the_untaken_branch_is_nan():
    """Inside a hybridized block both branches run on the device; the
    untaken ``sqrt`` of negative numbers is NaN forward and backward, and
    the gates keep it out of the gradient, which is ``lax.cond``'s."""
    x, w = _inputs(4, negative=True)
    got, grads = _held(_cond, x, w, "hybrid_record")
    np.testing.assert_allclose(grads[0], 2 * np.broadcast_to(w, x.shape),
                               **TOL)
    with mx.cpu():
        xs = mx.nd.array(x)
        xs.attach_grad()
        with mx.autograd.record():
            y = mx.nd.sum(mx.nd.sqrt(xs))
        y.backward()
        assert np.isnan(xs.grad.asnumpy()).all()


def test_cond_in_a_compiled_body_reads_nothing_on_the_host(monkeypatch):
    """Inside a compiled body ``cond`` never reads ``pred`` back (it would
    sync a card); outside one it does, and runs one branch."""
    x, w = _inputs(5)
    calls = []
    with mx.cpu():
        xs, ws = mx.nd.array(x), mx.nd.array(w)
        real = mx.nd.NDArray.asscalar

        def counted(self):
            calls.append(1)
            return real(self)

        monkeypatch.setattr(mx.nd.NDArray, "asscalar", counted)
        with mxc.nested():
            inside = _cond(mx, xs, ws)
        assert not calls
        outside = _cond(mx, xs, ws)
        assert calls
    np.testing.assert_allclose(inside.asnumpy(), outside.asnumpy(), **TOL)


def test_a_branch_leaves_tensors_it_made_ungated():
    """The gates wrap tensors from outside the branch once each, and no
    tensor the branch made itself."""
    from mxnet_tpu_torch.ndarray import contrib as c

    a = torch.ones(3, requires_grad=True)
    seen = []
    real = c._Gate.apply

    def apply(x, take):
        seen.append(x)
        return real(x, take)

    c._Gate.apply = apply
    try:
        with c._GatedBranch(torch.tensor(True)):
            b = a * 2
            d = b + a
            (d * b).sum()
    finally:
        c._Gate.apply = real
    assert len(seen) == 1 and seen[0] is a


@pytest.mark.parametrize("name", ["isfinite", "isnan", "isinf"])
def test_float_checks_match_jax(name):
    x = np.array([[1.0, np.nan, -np.inf], [np.inf, 0.0, -2.5]], np.float32)
    want = getattr(jmx.nd.contrib, name)(jmx.nd.array(x)).asnumpy()
    with mx.cpu():
        got = getattr(mx.nd.contrib, name)(mx.nd.array(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.asnumpy(), want)


def test_while_loop_needs_max_iterations():
    with mx.cpu(), pytest.raises(ValueError, match="max_iterations"):
        mx.nd.contrib.while_loop(lambda i: i < 1, lambda i: (i, i + 1),
                                 mx.nd.zeros((1,)))
