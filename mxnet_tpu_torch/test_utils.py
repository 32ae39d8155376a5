"""Testing utilities.

Counterpart of ``mxnet_tpu/test_utils.py`` (MXNet 1.x
``python/mxnet/test_utils.py``): ``default_context`` (:58, switched by
``MXNET_TEST_DEVICE``, e.g. ``gpu:0``), ``same``/``almost_equal``/
``assert_almost_equal`` with the same per-dtype tolerances (:664), the
``rand_*`` helpers, ``numeric_grad`` and ``check_numeric_gradient``
(:1101, central finite differences against ``autograd``, in float64),
``check_consistency`` (:1546, the same function on a list of contexts,
outputs and gradients cross-checked: the CPU against the card),
``simple_forward`` and ``environment``.
"""
from __future__ import annotations

import os

import numpy as np

from . import ndarray as nd
from .context import Context, cpu, current_context
from .ndarray import NDArray

__all__ = [
    "default_context", "set_default_context", "assert_almost_equal", "same",
    "almost_equal", "rand_ndarray", "rand_shape_nd", "rand_shape_2d",
    "rand_shape_3d", "check_numeric_gradient", "check_consistency",
    "environment", "default_dtype", "simple_forward", "numeric_grad",
]

_default_ctx = None


def default_context() -> Context:
    """Env-switched default test context (parity: test_utils.py:58,
    MXNET_TEST_DEVICE)."""
    global _default_ctx
    if _default_ctx is not None:
        return _default_ctx
    dev = os.environ.get("MXNET_TEST_DEVICE", "")
    if dev:
        name, _, idx = dev.partition(":")
        _default_ctx = Context(name, int(idx or 0))
    else:
        _default_ctx = current_context()
    return _default_ctx


def set_default_context(ctx: Context):
    global _default_ctx
    _default_ctx = ctx


def default_dtype():
    return np.float32


def _dtype_tol(*arrays):
    """Default (rtol, atol) scaled by the loosest dtype involved (parity:
    test_utils.py default_tols)."""
    tol = {np.dtype(np.float16): (1e-2, 1e-2),
           np.dtype(np.float32): (1e-4, 1e-5),
           np.dtype(np.float64): (1e-6, 1e-8)}
    rtol, atol = 1e-4, 1e-5
    for a in arrays:
        dt = getattr(a, "dtype", None)
        if dt is None:
            continue
        if str(dt) in ("bfloat16", "torch.bfloat16"):
            rtol, atol = max(rtol, 2e-2), max(atol, 2e-2)
            continue
        r, t = tol.get(np.dtype(str(dt).replace("torch.", "")),
                       (1e-4, 1e-5))
        rtol, atol = max(rtol, r), max(atol, t)
    return rtol, atol


def _to_numpy(a):
    if isinstance(a, NDArray):
        return a.asnumpy()
    return np.asarray(a)


def same(a, b) -> bool:
    return np.array_equal(_to_numpy(a), _to_numpy(b))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False) -> bool:
    a, b = _to_numpy(a), _to_numpy(b)
    if rtol is None or atol is None:
        drtol, datol = _dtype_tol(a, b)
        rtol = drtol if rtol is None else rtol
        atol = datol if atol is None else atol
    return np.allclose(a.astype(np.float64), b.astype(np.float64),
                       rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    an, bn = _to_numpy(a), _to_numpy(b)
    if rtol is None or atol is None:
        drtol, datol = _dtype_tol(an, bn)
        rtol = drtol if rtol is None else rtol
        atol = datol if atol is None else atol
    an64 = an.astype(np.float64)
    bn64 = bn.astype(np.float64)
    if np.allclose(an64, bn64, rtol=rtol, atol=atol, equal_nan=equal_nan):
        return
    err = np.abs(an64 - bn64)
    denom = np.maximum(np.abs(bn64), atol / max(rtol, 1e-300))
    rel = err / np.maximum(denom, 1e-300)
    idx = np.unravel_index(np.argmax(rel), rel.shape) if rel.size else ()
    raise AssertionError(
        f"Arrays {names[0]} and {names[1]} differ beyond rtol={rtol} atol={atol}: "
        f"max abs err {err.max() if err.size else 0:.3g}, max rel err "
        f"{rel.max() if rel.size else 0:.3g} at {idx}: "
        f"{names[0]}={an64[idx] if err.size else None} "
        f"{names[1]}={bn64[idx] if err.size else None}")


# ------------------------------------------------------------- random -------

def rand_shape_nd(ndim, dim=10, allow_zero_size=False):
    low = 0 if allow_zero_size else 1
    return tuple(np.random.randint(low, dim + 1, size=ndim))


def rand_shape_2d(dim0=10, dim1=10):
    return rand_shape_nd(2, max(dim0, dim1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return rand_shape_nd(3, max(dim0, dim1, dim2))


def rand_ndarray(shape, stype="default", density=None, dtype=None, ctx=None,
                 scale=1.0):
    data = np.random.uniform(-scale, scale, size=shape)
    if stype != "default":
        # a share ``density`` of the rows (row_sparse) or entries (csr)
        # kept, the rest zero
        keep = np.random.uniform(size=shape[:1] if stype == "row_sparse"
                                 else shape) < (0.5 if density is None
                                                else density)
        data = data * keep.reshape(keep.shape + (1,) * (data.ndim
                                                        - keep.ndim))
        return nd.array(data, ctx=ctx or default_context(),
                        dtype=dtype or np.float32).tostype(stype)
    return nd.array(data, ctx=ctx or default_context(),
                    dtype=dtype or np.float32)


# ------------------------------------------------- numeric gradient ---------

def numeric_grad(f, inputs, eps=1e-3):
    """Central finite differences of scalar-valued f w.r.t. each np input."""
    grads = []
    for i, x in enumerate(inputs):
        x = np.asarray(x, dtype=np.float64)
        g = np.zeros_like(x)
        flat = x.reshape(-1)
        gflat = g.reshape(-1)
        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            fp = float(f(*[inp if k != i else x for k, inp in enumerate(inputs)]))
            flat[j] = orig - eps
            fm = float(f(*[inp if k != i else x for k, inp in enumerate(inputs)]))
            flat[j] = orig
            gflat[j] = (fp - fm) / (2 * eps)
        grads.append(g)
    return grads


def check_numeric_gradient(op_name, input_arrays, kwargs=None, rtol=1e-2,
                           atol=1e-3, eps=1e-3):
    """Check the autograd gradient of ``sum(op(*inputs))`` against
    central finite differences, both in float64 on the CPU (MXNet 1.x
    :1101; the JAX package scopes x64 on for this)."""
    with cpu():
        _check_numeric_gradient_x64(op_name, input_arrays, kwargs, rtol, atol,
                                    eps)


def _check_numeric_gradient_x64(op_name, input_arrays, kwargs, rtol, atol, eps):
    from . import autograd

    kwargs = kwargs or {}
    nds = [nd.array(np.asarray(a, dtype=np.float64), dtype="float64")
           for a in input_arrays]
    for x in nds:
        x.attach_grad()
    with autograd.record():
        out = nd.invoke(op_name, *nds, **kwargs)
        if isinstance(out, tuple):
            out = out[0]
        loss = out.sum()
    loss.backward()
    sym_grads = [x.grad.asnumpy() for x in nds]

    def f(*np_inputs):
        arrs = [nd.array(a, dtype="float64") for a in np_inputs]
        o = nd.invoke(op_name, *arrs, **kwargs)
        if isinstance(o, tuple):
            o = o[0]
        return o.sum().asscalar()

    num_grads = numeric_grad(f, [np.asarray(a, dtype=np.float64)
                                 for a in input_arrays], eps=eps)
    for i, (s, n) in enumerate(zip(sym_grads, num_grads)):
        assert_almost_equal(s, n, rtol=rtol, atol=atol,
                            names=(f"autograd_grad[{i}]", f"numeric_grad[{i}]"))


def check_consistency(fn, input_shapes, ctx_list=None, dtypes=None, rtol=None,
                      atol=None, grad=True):
    """Run `fn(*NDArrays)` on every (ctx, dtype) combination and cross-assert
    outputs (+ grads) against the first one (parity: test_utils.py:1546).

    By default it compares the CPU with ``default_context()`` (the card
    where one is present), MXNet's cpu-vs-gpu check.
    """
    from . import autograd

    if ctx_list is None:
        ctx_list = [cpu(0), default_context()]
    if dtypes is None:
        dtypes = [np.float32]
    base_np = [np.random.uniform(-1, 1, size=s) for s in input_shapes]
    ref_out = ref_grads = None
    for ctx in ctx_list:
        for dtype in dtypes:
            nds = [nd.array(a, ctx=ctx, dtype=dtype) for a in base_np]
            if grad:
                for x in nds:
                    x.attach_grad()
                with autograd.record():
                    out = fn(*nds)
                    loss = out.sum()
                loss.backward()
                grads = [x.grad.asnumpy() for x in nds]
            else:
                out = fn(*nds)
                grads = []
            o = out.asnumpy()
            if ref_out is None:
                ref_out, ref_grads = o, grads
            else:
                assert_almost_equal(o, ref_out, rtol=rtol, atol=atol,
                                    names=(f"out@{ctx}/{np.dtype(dtype).name}", "ref"))
                for i, (g, rg) in enumerate(zip(grads, ref_grads)):
                    assert_almost_equal(g, rg, rtol=rtol, atol=atol,
                                        names=(f"grad[{i}]@{ctx}", "ref"))
    return ref_out


def simple_forward(op_name, *np_inputs, **kwargs):
    out = nd.invoke(op_name, *[nd.array(a, ctx=default_context())
                               for a in np_inputs], **kwargs)
    if isinstance(out, tuple):
        return tuple(o.asnumpy() for o in out)
    return out.asnumpy()


class environment:
    """Context manager patching environment variables (parity:
    test_utils.py `with environment(...)`)."""

    def __init__(self, *args):
        if len(args) == 2:
            self._vars = {args[0]: args[1]}
        else:
            self._vars = dict(args[0])
        self._saved = {}

    def __enter__(self):
        for k, v in self._vars.items():
            self._saved[k] = os.environ.get(k)
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        return self

    def __exit__(self, *exc):
        for k, old in self._saved.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
