"""mx.np: the NumPy-compatible frontend.

Counterpart of ``mxnet_tpu/numpy/__init__.py`` (MXNet 1.x
``python/mxnet/numpy/multiarray.py``). ``mx.np.ndarray`` follows NumPy
semantics (zero-dim arrays, boolean masks, bool comparison results,
``@``, NumPy type promotion as the JAX package computes it with 64-bit
types off) while staying a framework array: it lives on a Context, takes
``attach_grad``/``autograd.record()``, hybridizes, and its ops go
through the registry (``ops/numpy_ops.py``), so any op with an
``mx.np.ndarray`` input returns one.

Creation functions take ``ctx`` and default to the current context (the
card). Host data without an explicit ``dtype`` takes the JAX package's
32-bit widths (int64 becomes int32, float64 float32); an explicit 64-bit
``dtype`` is kept. ``dtype`` reads as a numpy dtype (``torch.bfloat16``
for bfloat16, which numpy lacks).

The numpy dispatch protocol (``__array_ufunc__``, ``__array_function__``)
routes a numpy function called on these arrays to the ``mx.np``
function of its name, else to numpy itself on host copies (MXNet's
``numpy_op_fallback`` contract), re-wrapping the result. Each such
fallback appends the numpy function's name to the lists of the open
:func:`watching_fallbacks` scopes of its thread, as
``registry.watching_host_ops`` does for host ops.
"""
from __future__ import annotations

import builtins as _builtins
import contextlib as _contextlib
import threading as _threading

import numpy as _onp
import torch

from ..base import canonical_dtype
from ..context import current_context
from ..ndarray.ndarray import NDArray, _invoke, _invoke_fn
from ..ops import registry as _reg

# re-exported numpy dtype/constant surface (numpy/__init__.py)
from numpy import (float16, float32, float64, int8, int16, int32, int64,  # noqa: F401
                   uint8, uint16, uint32, uint64, bool_, pi, e, inf, nan,
                   euler_gamma, newaxis)

_tls = _threading.local()


@_contextlib.contextmanager
def watching_fallbacks():
    """Within the scope, each numpy fallback taken on this thread appends
    the numpy function's name to the list the scope yields; scopes
    nest."""
    seen = []
    stack = getattr(_tls, "watch", None)
    if stack is None:
        stack = _tls.watch = []
    stack.append(seen)
    try:
        yield seen
    finally:
        stack.pop()


def _np_dtype(dt):
    if dt == torch.bfloat16:
        return dt
    return _onp.dtype(str(dt).replace("torch.", ""))


def _index(key):
    """An index expression with arrays made tensors (integer ones as
    int64, which torch indexes with)."""
    if isinstance(key, NDArray):
        key = key._data
    elif isinstance(key, _onp.ndarray):
        key = torch.from_numpy(_onp.ascontiguousarray(key))
    elif isinstance(key, tuple):
        return tuple(_index(k) for k in key)
    elif isinstance(key, list) and any(isinstance(k, (NDArray, list))
                                       for k in key):
        return [_index(k) for k in key]
    if isinstance(key, torch.Tensor) and key.dtype not in (torch.bool,
                                                           torch.int64):
        key = key.long()
    return key


class ndarray(NDArray):
    """NumPy-semantics array (MXNet 1.x ``numpy/multiarray.py`` ndarray)."""

    __slots__ = ()
    _np_frontend = True  # _invoke propagates this class through ops

    @property
    def dtype(self):
        return _np_dtype(self._data.dtype)

    # ------------------------------------------------------------- repr ----
    def __repr__(self):
        arr = self.asnumpy()
        prefix = "array("
        body = _onp.array2string(arr, separator=", ", prefix=prefix)
        ctx = self.context
        suffix = f", ctx={ctx})" if ctx.device_type != "cpu" else ")"
        if arr.dtype not in (_onp.float32, _onp.int32, _onp.bool_):
            suffix = f", dtype={arr.dtype}" + suffix
        return prefix + body + suffix

    def __str__(self):
        return str(self.asnumpy())

    # ----------------------------------------------------------- indexing --
    def __getitem__(self, key):
        """NumPy indexing: integer and boolean arrays, ``newaxis``, slices,
        zero-dim results. A boolean mask's result has the data's shape,
        so reading it waits for the device."""
        key = _index(key)
        return _invoke_fn(lambda x: x[key], [self], wrap=ndarray)

    def __setitem__(self, key, value):
        """``a[key] = value`` rebinds ``a`` to a copy with the positions
        written. A boolean mask of the array's shape (or of its leading
        axes) with a scalar or broadcastable value is a
        ``_npi_boolean_mask_assign_*`` op: the input's shape, no host
        read."""
        k = _index(key)
        if isinstance(k, torch.Tensor) and k.dtype == torch.bool and \
                k.ndim <= self.ndim and \
                tuple(k.shape) == self.shape[:k.ndim]:
            mask = ndarray(k.reshape(k.shape + (1,) * (self.ndim - k.ndim)))
            if isinstance(value, (int, float, bool)):
                out = _invoke("_npi_boolean_mask_assign_scalar",
                              [self, mask], {"value": value}, wrap=ndarray)
            else:
                v = _as_np(value, ctx=self.context)
                out = _invoke("_npi_boolean_mask_assign_tensor",
                              [self, mask, v], {}, wrap=ndarray)
            self._rebind(out._data.to(self._data.dtype))
            return
        NDArray.__setitem__(self, k, value)

    # ------------------------------------------- numpy dispatch protocol ---
    # (MXNet 1.x numpy_dispatch_protocol.py and numpy_op_fallback.py)
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        out = kwargs.pop("out", None)
        if method == "at":
            # an update in place: on a host copy, then rebound
            target = inputs[0]
            host = _onp.array(target.asnumpy())
            _note_fallback(f"{ufunc.__name__}.at")
            ufunc.at(host, *self._unwrap(tuple(inputs[1:])))
            target[:] = array(host, ctx=target.context)
            return None
        if out is not None and (kwargs or method != "__call__"):
            # numpy applies the out semantics (where= keeps the out array's
            # values) on host copies; the results are rebound
            host_outs = tuple(_onp.array(t.asnumpy())
                              for t in (out if isinstance(out, tuple)
                                        else (out,)))
            kwargs["out"] = host_outs if len(host_outs) > 1 else host_outs[0]
            self._numpy_fallback(getattr(ufunc, method), inputs, kwargs)
            return self._fill_out(
                host_outs if len(host_outs) > 1 else array(host_outs[0]),
                out)
        if method != "__call__":
            result = self._numpy_fallback(getattr(ufunc, method), inputs,
                                          kwargs)
        elif not kwargs:
            # the mx function for a plain call only: numpy's own keywords
            # (where=, dtype=, casting=) fall back wholesale
            fn = globals().get(ufunc.__name__)
            if fn is not None:
                try:
                    result = fn(*inputs)
                except TypeError:
                    result = self._numpy_fallback(ufunc, inputs, kwargs)
            else:
                result = self._numpy_fallback(ufunc, inputs, kwargs)
        else:
            result = self._numpy_fallback(ufunc, inputs, kwargs)
        return self._fill_out(result, out)

    def __array_function__(self, func, types, args, kwargs):
        out = kwargs.pop("out", None)
        if out is None and kwargs.get("where") is None:
            fn = globals().get(func.__name__)
            if fn is not None and fn is not func:
                try:
                    return fn(*args, **kwargs)
                except TypeError:
                    pass
        return self._fill_out(self._numpy_fallback(func, args, kwargs), out)

    @staticmethod
    def _fill_out(result, out):
        """numpy's ``out=``: the result written into the given array(s),
        which are returned."""
        if out is None:
            return result
        targets = out if isinstance(out, tuple) else (out,)
        results = result if isinstance(result, tuple) else (result,)
        for t, r in zip(targets, results):
            t[:] = r if isinstance(r, NDArray) else array(r)
        return targets[0] if len(targets) == 1 else out

    @staticmethod
    def _unwrap(args):
        def unwrap(x):
            if isinstance(x, NDArray):
                # copies: numpy may write into its operands
                return _onp.array(x.asnumpy())
            if isinstance(x, (list, tuple)):
                return type(x)(unwrap(v) for v in x)
            return x

        return unwrap(tuple(args))

    @staticmethod
    def _numpy_fallback(func, args, kwargs):
        _note_fallback(getattr(func, "__name__", repr(func)))
        out = func(*ndarray._unwrap(tuple(args)),
                   **{k: ndarray._unwrap((v,))[0] for k, v in kwargs.items()})
        if isinstance(out, _onp.ndarray):
            return array(out)
        if isinstance(out, tuple):
            return tuple(array(o) if isinstance(o, _onp.ndarray) else o
                         for o in out)
        return out

    # -------------------------------------------------------- operators ----
    def _bin(self, other, op, scalar_op=None, reverse=False):
        if isinstance(other, NDArray):
            args = [other, self] if reverse else [self, other]
            return _invoke(op, args, {}, wrap=ndarray)
        if scalar_op is not None and isinstance(other, (int, float, bool)):
            name = ("_npi_r" + scalar_op if reverse else
                    "_npi_" + scalar_op) + "_scalar"
            try:
                return _invoke(name, [self], {"scalar": other}, wrap=ndarray)
            except KeyError:
                pass
        other = array(other, ctx=self.context)
        args = [other, self] if reverse else [self, other]
        return _invoke(op, args, {}, wrap=ndarray)

    def __add__(self, o):
        return self._bin(o, "_npi_add", "add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(o, "_npi_subtract", "subtract")

    def __rsub__(self, o):
        return self._bin(o, "_npi_subtract", "subtract", reverse=True)

    def __mul__(self, o):
        return self._bin(o, "_npi_multiply", "multiply")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin(o, "_npi_true_divide", "true_divide")

    def __rtruediv__(self, o):
        return self._bin(o, "_npi_true_divide", "true_divide", reverse=True)

    def __floordiv__(self, o):
        return self._bin(o, "_npi_floor_divide", "floor_divide")

    def __rfloordiv__(self, o):
        return self._bin(o, "_npi_floor_divide", "floor_divide",
                         reverse=True)

    def __mod__(self, o):
        return self._bin(o, "_npi_mod", "mod")

    def __rmod__(self, o):
        return self._bin(o, "_npi_mod", "mod", reverse=True)

    def __pow__(self, o):
        return self._bin(o, "_npi_power", "power")

    def __rpow__(self, o):
        return self._bin(o, "_npi_power", "power", reverse=True)

    def __matmul__(self, o):
        return self._bin(o, "_npi_matmul")

    def __rmatmul__(self, o):
        return self._bin(o, "_npi_matmul", reverse=True)

    def __neg__(self):
        return _invoke("_npi_negative", [self], {}, wrap=ndarray)

    def __abs__(self):
        return _invoke("_npi_absolute", [self], {}, wrap=ndarray)

    def __invert__(self):
        return _invoke("_npi_invert", [self], {}, wrap=ndarray)

    def __eq__(self, o):
        return self._bin(o, "_npi_equal")

    def __ne__(self, o):
        return self._bin(o, "_npi_not_equal")

    def __lt__(self, o):
        return self._bin(o, "_npi_less")

    def __le__(self, o):
        return self._bin(o, "_npi_less_equal")

    def __gt__(self, o):
        return self._bin(o, "_npi_greater")

    def __ge__(self, o):
        return self._bin(o, "_npi_greater_equal")

    __hash__ = NDArray.__hash__

    def __and__(self, o):
        return self._bin(o, "_npi_bitwise_and")

    def __or__(self, o):
        return self._bin(o, "_npi_bitwise_or")

    def __xor__(self, o):
        return self._bin(o, "_npi_bitwise_xor")

    def __iadd__(self, o):
        self._rebind((self + o)._data)
        return self

    def __isub__(self, o):
        self._rebind((self - o)._data)
        return self

    def __imul__(self, o):
        self._rebind((self * o)._data)
        return self

    def __itruediv__(self, o):
        self._rebind((self / o)._data)
        return self

    # --------------------------------------------------------- methods -----
    @property
    def T(self):  # noqa: N802 - numpy's name
        return _invoke("_npi_transpose", [self], {}, wrap=ndarray)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _invoke("_npi_transpose", [self],
                       {"axes": axes or None}, wrap=ndarray)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _invoke("_npi_reshape", [self], {"newshape": shape},
                       wrap=ndarray)

    def flatten(self, order="C"):
        return _invoke("_npi_ravel", [self], {}, wrap=ndarray)

    ravel = flatten

    def astype(self, dtype, copy=True):
        dt = canonical_dtype(dtype)
        return _invoke_fn(lambda x: x.to(dt), [self], wrap=ndarray)

    def item(self, *args):
        return self.asnumpy().item(*args)

    def tolist(self):
        return self.asnumpy().tolist()

    def as_nd_ndarray(self):
        """This array in the legacy mx.nd frontend (the same tensor, so
        its autograd history is kept)."""
        return NDArray(self._data)

    def as_np_ndarray(self):
        return self

    def sum(self, axis=None, dtype=None, keepdims=False):
        return _invoke("_npi_sum", [self],
                       {"axis": axis, "dtype": _npdt(dtype),
                        "keepdims": keepdims}, wrap=ndarray)

    def mean(self, axis=None, dtype=None, keepdims=False):
        return _invoke("_npi_mean", [self],
                       {"axis": axis, "dtype": _npdt(dtype),
                        "keepdims": keepdims}, wrap=ndarray)

    def std(self, axis=None, ddof=0, keepdims=False):
        return _invoke("_npi_std", [self], {"axis": axis, "ddof": ddof,
                                            "keepdims": keepdims},
                       wrap=ndarray)

    def var(self, axis=None, ddof=0, keepdims=False):
        return _invoke("_npi_var", [self], {"axis": axis, "ddof": ddof,
                                            "keepdims": keepdims},
                       wrap=ndarray)

    def prod(self, axis=None, keepdims=False):
        return _invoke("_npi_prod", [self], {"axis": axis,
                                             "keepdims": keepdims},
                       wrap=ndarray)

    def max(self, axis=None, keepdims=False):
        return _invoke("_npi_max", [self], {"axis": axis,
                                            "keepdims": keepdims},
                       wrap=ndarray)

    def min(self, axis=None, keepdims=False):
        return _invoke("_npi_min", [self], {"axis": axis,
                                            "keepdims": keepdims},
                       wrap=ndarray)

    def argmax(self, axis=None):
        return _invoke("_npi_argmax", [self], {"axis": axis}, wrap=ndarray)

    def argmin(self, axis=None):
        return _invoke("_npi_argmin", [self], {"axis": axis}, wrap=ndarray)

    def clip(self, min=None, max=None):  # noqa: A002 - numpy's names
        return _invoke("_npi_clip", [self], {"a_min": min, "a_max": max},
                       wrap=ndarray)

    def squeeze(self, axis=None):
        return _invoke("_npi_squeeze", [self], {"axis": axis}, wrap=ndarray)

    def cumsum(self, axis=None, dtype=None):
        return _invoke("_npi_cumsum", [self],
                       {"axis": axis, "dtype": _npdt(dtype)}, wrap=ndarray)

    def round(self, decimals=0):
        return _invoke("_npi_round", [self], {"decimals": decimals},
                       wrap=ndarray)

    def dot(self, b):
        return self._bin(b, "_npi_dot")

    def copy(self):
        return _invoke("_np_copy", [self], {}, wrap=ndarray)

    def any(self, axis=None, keepdims=False):
        return _invoke("_npi_any", [self], {"axis": axis,
                                            "keepdims": keepdims},
                       wrap=ndarray)

    def all(self, axis=None, keepdims=False):
        return _invoke("_npi_all", [self], {"axis": axis,
                                            "keepdims": keepdims},
                       wrap=ndarray)


def _note_fallback(name):
    for seen in getattr(_tls, "watch", ()):
        seen.append(name)


def _npdt(dtype):
    """A dtype argument's name (None passes through)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return _onp.dtype(dtype).name


def _as_np(x, ctx=None):
    if isinstance(x, ndarray):
        return x
    if isinstance(x, NDArray):
        return ndarray(x._data)
    return array(x, ctx=ctx)


# ------------------------------------------------------------- creation ----
_NARROW = {_onp.dtype("int64"): "int32", _onp.dtype("float64"): "float32",
           _onp.dtype("uint64"): "int32"}


def array(object, dtype=None, ctx=None):  # noqa: A002 - numpy's name
    """An ``mx.np.ndarray`` of ``object`` (MXNet 1.x multiarray.py
    ``array``), on ``ctx`` (the current context by default)."""
    if isinstance(object, NDArray):
        t = object._data
        if ctx is not None:
            t = t.to(ctx.torch_device())
        return ndarray(t if dtype is None else t.to(canonical_dtype(dtype)))
    if isinstance(object, torch.Tensor):
        return ndarray(object, ctx=ctx, dtype=_npdt(dtype))
    host = _onp.asarray(object)
    if dtype is None:
        dtype = _NARROW.get(host.dtype, host.dtype.name)
    return ndarray(host, ctx=ctx or current_context(), dtype=_npdt(dtype))


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _device(ctx):
    return (ctx or current_context()).torch_device()


def zeros(shape, dtype=None, order="C", ctx=None):
    return ndarray(torch.zeros(_shape(shape),
                               dtype=canonical_dtype(dtype or "float32"),
                               device=_device(ctx)))


def ones(shape, dtype=None, order="C", ctx=None):
    return ndarray(torch.ones(_shape(shape),
                              dtype=canonical_dtype(dtype or "float32"),
                              device=_device(ctx)))


def full(shape, fill_value, dtype=None, order="C", ctx=None):
    if dtype is None:
        dtype = _NARROW.get(_onp.asarray(fill_value).dtype,
                            _onp.asarray(fill_value).dtype.name)
    return ndarray(torch.full(_shape(shape), fill_value,
                              dtype=canonical_dtype(dtype),
                              device=_device(ctx)))


def empty(shape, dtype=None, order="C", ctx=None):
    return zeros(shape, dtype=dtype, ctx=ctx)


def arange(start, stop=None, step=1, dtype=None, ctx=None):
    return array(_onp.arange(start, stop, step, dtype=_npdt(dtype)), ctx=ctx)


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None):
    out = _onp.linspace(start, stop, num, endpoint=endpoint,
                        retstep=retstep, dtype=_npdt(dtype), axis=axis)
    if retstep:
        return array(out[0], ctx=ctx), out[1]
    return array(out, ctx=ctx)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, ctx=None):
    return array(_onp.logspace(start, stop, num, endpoint=endpoint,
                               base=base, dtype=_npdt(dtype), axis=axis),
                 ctx=ctx)


def eye(N, M=None, k=0, dtype=None, ctx=None):  # noqa: N803
    return _invoke("_npi_eye", [], {"N": N, "M": M, "k": k,
                                    "dtype": _npdt(dtype) or "float32",
                                    "device": _device(ctx)}, wrap=ndarray)


def identity(n, dtype=None, ctx=None):
    return eye(n, dtype=dtype, ctx=ctx)


def zeros_like(a, dtype=None):
    dt = None if dtype is None else canonical_dtype(dtype)
    return _invoke_fn(lambda x: torch.zeros_like(x, dtype=dt),
                      [_as_np(a)], wrap=ndarray)


def ones_like(a, dtype=None):
    dt = None if dtype is None else canonical_dtype(dtype)
    return _invoke_fn(lambda x: torch.ones_like(x, dtype=dt),
                      [_as_np(a)], wrap=ndarray)


def full_like(a, fill_value, dtype=None):
    dt = None if dtype is None else canonical_dtype(dtype)
    return _invoke_fn(lambda x: torch.full_like(x, fill_value, dtype=dt),
                      [_as_np(a)], wrap=ndarray)


def empty_like(a, dtype=None):
    return zeros_like(a, dtype=dtype)


def copy(a):
    return _as_np(a).copy()


def ascontiguousarray(a, dtype=None):
    return _as_np(a) if dtype is None else _as_np(a).astype(dtype)


asarray = array


# ------------------------------------------------------------ dispatch -----

def _op1(op_name):
    """A one-array op's function: ``np.f(a, *args, **kwargs)``, the
    positional arguments bound onto the op's parameters in order."""
    kw_names = None

    def f(a, *args, **kwargs):
        nonlocal kw_names
        a = _as_np(a)
        if args:
            if kw_names is None:
                kw_names = tuple(_reg.schema(op_name).params)
            if len(args) > len(kw_names):
                raise TypeError(
                    f"{f.__name__}() takes at most {len(kw_names)} "
                    f"positional arguments after the array")
            kwargs.update(dict(zip(kw_names, args)))
        return _invoke(op_name, [a], kwargs, wrap=ndarray)

    f.__name__ = op_name.replace("_npi_", "")
    return f


def _op2(op_name, scalar_name=None):
    """A two-array op's function, with Python numbers on either side."""

    def f(x1, x2, *a, **k):
        if isinstance(x1, NDArray):
            return _as_np(x1)._bin(x2, op_name, scalar_name)
        if isinstance(x2, NDArray):
            return _as_np(x2)._bin(x1, op_name, scalar_name, reverse=True)
        return f(array(x1), x2)

    f.__name__ = op_name.replace("_npi_", "")
    return f


for _n in ("negative", "reciprocal", "absolute", "sign", "rint", "ceil",
           "floor", "trunc", "fix", "square", "sqrt", "cbrt", "exp",
           "expm1", "log", "log10", "log2", "log1p", "sin", "cos", "tan",
           "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
           "arccosh", "arctanh", "degrees", "radians", "invert",
           "logical_not", "isnan", "isinf", "isposinf", "isneginf",
           "isfinite", "conj", "real", "imag"):
    globals()[_n] = _op1(f"_npi_{_n}")
abs = absolute  # noqa: F821,A001

for _n in ("add", "subtract", "multiply", "true_divide", "floor_divide",
           "mod", "fmod", "remainder", "power", "maximum", "minimum",
           "fmax", "fmin", "hypot", "arctan2", "copysign", "ldexp",
           "logaddexp", "bitwise_and", "bitwise_or", "bitwise_xor",
           "left_shift", "right_shift", "logical_and", "logical_or",
           "logical_xor", "equal", "not_equal", "less", "less_equal",
           "greater", "greater_equal", "matmul", "dot", "inner", "outer",
           "kron", "cross", "gcd", "lcm", "vdot"):
    _scalar = _n if _n in ("add", "subtract", "multiply", "true_divide",
                           "mod", "power", "floor_divide") else None
    globals()[_n] = _op2(f"_npi_{_n}", _scalar)
divide = true_divide  # noqa: F821


def sum(a, axis=None, dtype=None, keepdims=False):  # noqa: A001
    return _as_np(a).sum(axis=axis, dtype=dtype, keepdims=keepdims)


def mean(a, axis=None, dtype=None, keepdims=False):
    return _as_np(a).mean(axis=axis, dtype=dtype, keepdims=keepdims)


def std(a, axis=None, ddof=0, keepdims=False):
    return _as_np(a).std(axis=axis, ddof=ddof, keepdims=keepdims)


def var(a, axis=None, ddof=0, keepdims=False):
    return _as_np(a).var(axis=axis, ddof=ddof, keepdims=keepdims)


def prod(a, axis=None, keepdims=False):
    return _as_np(a).prod(axis=axis, keepdims=keepdims)


def max(a, axis=None, keepdims=False):  # noqa: A001
    return _as_np(a).max(axis=axis, keepdims=keepdims)


def min(a, axis=None, keepdims=False):  # noqa: A001
    return _as_np(a).min(axis=axis, keepdims=keepdims)


amax, amin = max, min


def argmax(a, axis=None):
    return _as_np(a).argmax(axis=axis)


def argmin(a, axis=None):
    return _as_np(a).argmin(axis=axis)


def clip(a, a_min=None, a_max=None):
    return _as_np(a).clip(a_min, a_max)


for _n in ("cumsum", "cumprod", "nansum", "nanprod", "median", "ptp",
           "any", "all", "count_nonzero", "sort", "argsort", "unique",
           "ravel", "fliplr", "flipud",
           "atleast_1d", "atleast_2d", "atleast_3d", "trace", "diag",
           "diagonal", "diagflat", "tril", "triu", "nan_to_num"):
    globals()[_n] = _op1(f"_npi_{_n}")


def reshape(a, newshape, order="C"):
    return _as_np(a).reshape(newshape)


def transpose(a, axes=None):
    return _invoke("_npi_transpose", [_as_np(a)],
                   {"axes": None if axes is None else tuple(axes)},
                   wrap=ndarray)


def swapaxes(a, axis1, axis2):
    return _invoke("_npi_swapaxes", [_as_np(a)],
                   {"dim1": axis1, "dim2": axis2}, wrap=ndarray)


def moveaxis(a, source, destination):
    return _invoke("_npi_moveaxis", [_as_np(a)],
                   {"source": source, "destination": destination},
                   wrap=ndarray)


def expand_dims(a, axis):
    return _invoke("_npi_expand_dims", [_as_np(a)], {"axis": axis},
                   wrap=ndarray)


def squeeze(a, axis=None):
    return _as_np(a).squeeze(axis)


def broadcast_to(a, shape):
    return _invoke("_npi_broadcast_to", [_as_np(a)], {"shape": tuple(shape)},
                   wrap=ndarray)


def flip(a, axis=None):
    return _invoke("_npi_flip", [_as_np(a)], {"axis": axis}, wrap=ndarray)


def roll(a, shift, axis=None):
    return _invoke("_npi_roll", [_as_np(a)], {"shift": shift, "axis": axis},
                   wrap=ndarray)


def rot90(a, k=1, axes=(0, 1)):
    return _invoke("_npi_rot90", [_as_np(a)], {"k": k, "axes": tuple(axes)},
                   wrap=ndarray)


def tile(a, reps):
    return _invoke("_npi_tile", [_as_np(a)],
                   {"reps": reps if isinstance(reps, int) else tuple(reps)},
                   wrap=ndarray)


def repeat(a, repeats, axis=None):
    return _invoke("_npi_repeat", [_as_np(a)],
                   {"repeats": repeats, "axis": axis}, wrap=ndarray)


def _freeze_pads(pw):
    if isinstance(pw, int):
        return pw
    return tuple(tuple(p) if isinstance(p, (list, tuple)) else p
                 for p in pw)


def pad(a, pad_width, mode="constant", constant_values=0):
    return _invoke("_npi_pad", [_as_np(a)],
                   {"pad_width": _freeze_pads(pad_width), "mode": mode,
                    "constant_values": constant_values}, wrap=ndarray)


def concatenate(seq, axis=0, out=None):
    return _invoke("_npi_concatenate", [_as_np(a) for a in seq],
                   {"axis": axis}, wrap=ndarray)


def stack(arrays, axis=0, out=None):
    return _invoke("_npi_stack", [_as_np(a) for a in arrays],
                   {"axis": axis}, wrap=ndarray)


def vstack(tup):
    return _invoke("_npi_vstack", [_as_np(a) for a in tup], {}, wrap=ndarray)


def hstack(tup):
    return _invoke("_npi_hstack", [_as_np(a) for a in tup], {}, wrap=ndarray)


def dstack(tup):
    return _invoke("_npi_dstack", [_as_np(a) for a in tup], {}, wrap=ndarray)


def column_stack(tup):
    return _invoke("_npi_column_stack", [_as_np(a) for a in tup], {},
                   wrap=ndarray)


def _split(op, ary, ios, **kw):
    if isinstance(ios, (list, tuple)):
        ios = tuple(ios)
    out = _invoke(op, [_as_np(ary)], {"indices_or_sections": ios, **kw},
                  wrap=ndarray)
    return list(out) if isinstance(out, tuple) else [out]


def split(ary, indices_or_sections, axis=0):
    return _split("_npi_split", ary, indices_or_sections, axis=axis)


def array_split(ary, indices_or_sections, axis=0):
    return _split("_npi_array_split", ary, indices_or_sections, axis=axis)


def hsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=1)


def vsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=0)


def dsplit(ary, indices_or_sections):
    return split(ary, indices_or_sections, axis=2)


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    if not isinstance(x, NDArray) and not isinstance(y, NDArray):
        return _invoke("_npi_where_scalar2", [_as_np(condition)],
                       {"lscalar": x, "rscalar": y}, wrap=ndarray)
    if not isinstance(y, NDArray):
        return _invoke("_npi_where_lscalar", [_as_np(condition), _as_np(x)],
                       {"scalar": y}, wrap=ndarray)
    if not isinstance(x, NDArray):
        return _invoke("_npi_where_rscalar", [_as_np(condition), _as_np(y)],
                       {"scalar": x}, wrap=ndarray)
    return _invoke("_npi_where",
                   [_as_np(condition), _as_np(x), _as_np(y)], {},
                   wrap=ndarray)


def nonzero(a):
    """A tuple of 1-D index arrays (numpy's contract)."""
    out = _invoke("_npi_nonzero", [_as_np(a)], {}, wrap=ndarray)
    return out if isinstance(out, tuple) else (out,)


def take(a, indices, axis=None, mode="clip"):
    return _invoke("_npi_take", [_as_np(a), _as_np(indices)],
                   {"axis": axis, "mode": mode}, wrap=ndarray)


def take_along_axis(a, indices, axis):
    return _invoke("_npi_take_along_axis", [_as_np(a), _as_np(indices)],
                   {"axis": axis}, wrap=ndarray)


def searchsorted(a, v, side="left"):
    return _invoke("_npi_searchsorted", [_as_np(a), _as_np(v)],
                   {"side": side}, wrap=ndarray)


def bincount(x, weights=None, minlength=0):
    kw = {"minlength": minlength}
    if weights is not None:
        kw["weights"] = _as_np(weights, ctx=_as_np(x).context)._data
    return _invoke("_npi_bincount", [_as_np(x)], kw, wrap=ndarray)


def histogram(a, bins=10, range=None):  # noqa: A002
    return _invoke("_npi_histogram", [_as_np(a)],
                   {"bins": bins, "range": range}, wrap=ndarray)


def interp(x, xp, fp):
    return _invoke("_npi_interp", [_as_np(x), _as_np(xp), _as_np(fp)], {},
                   wrap=ndarray)


def diff(a, n=1, axis=-1):
    return _invoke("_npi_diff", [_as_np(a)], {"n": n, "axis": axis},
                   wrap=ndarray)


def gradient(f, axis=None):
    out = _invoke("_npi_gradient_op", [_as_np(f)], {"axis": axis},
                  wrap=ndarray)
    return list(out) if isinstance(out, tuple) else out


def meshgrid(*xi, indexing="xy"):
    out = _invoke("_npi_meshgrid", [_as_np(x) for x in xi],
                  {"indexing": indexing}, wrap=ndarray)
    return list(out) if isinstance(out, tuple) else [out]


def einsum(subscripts, *operands):
    return _invoke("_npi_einsum", [_as_np(o) for o in operands],
                   {"subscripts": subscripts}, wrap=ndarray)


def tensordot(a, b, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = tuple(tuple(ax) if isinstance(ax, (list, tuple)) else ax
                     for ax in axes)
    return _invoke("_npi_tensordot", [_as_np(a), _as_np(b)],
                   {"axes": axes}, wrap=ndarray)


def quantile(a, q, axis=None, keepdims=False):
    return _invoke("_npi_quantile", [_as_np(a)],
                   {"q": q, "axis": axis, "keepdims": keepdims},
                   wrap=ndarray)


def percentile(a, q, axis=None, keepdims=False):
    return _invoke("_npi_percentile", [_as_np(a)],
                   {"q": q, "axis": axis, "keepdims": keepdims},
                   wrap=ndarray)


def average(a, axis=None, weights=None):
    kw = {"axis": axis}
    if weights is not None:
        kw["weights"] = _as_np(weights, ctx=_as_np(a).context)._data
    return _invoke("_npi_average", [_as_np(a)], kw, wrap=ndarray)


def maximum_sctype(t):
    return _onp.float64


def may_share_memory(a, b, max_work=None):
    return bool(_invoke("_npi_share_memory", [_as_np(a), _as_np(b)], {},
                        wrap=ndarray).item())


shares_memory = may_share_memory


def result_type(*args):
    """numpy's result type of the arguments, from their dtypes alone (no
    device read)."""
    return _onp.result_type(*[
        _onp.dtype(_npdt(a._data.dtype)) if isinstance(a, NDArray) else a
        for a in args])


def isscalar(element):
    return _onp.isscalar(element)


def shape(a):
    return _as_np(a).shape


def ndim(a):
    return _as_np(a).ndim


def size(a, axis=None):
    if axis is None:
        return _as_np(a).size
    return _as_np(a).shape[axis]


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _builtins.bool(_onp.allclose(
        _as_np(a).asnumpy(), _as_np(b).asnumpy(), rtol=rtol, atol=atol,
        equal_nan=equal_nan))


def array_equal(a1, a2):
    return _builtins.bool(_onp.array_equal(_as_np(a1).asnumpy(),
                                           _as_np(a2).asnumpy()))


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _invoke_fn(lambda x, y: torch.isclose(
        x, y.to(x.dtype), rtol=rtol, atol=atol, equal_nan=equal_nan),
        [_as_np(a), _as_np(b)], wrap=ndarray)


def dtype(d):  # noqa: A001
    return _onp.dtype(d)


from . import linalg  # noqa: E402,F401
from . import random  # noqa: E402,F401


# ----------------------------------------------------- np frontend tail ----

def hanning(M, dtype=None, ctx=None):  # noqa: N803
    return _invoke("_npi_hanning", [], {"M": int(M),
                                        "device": _device(ctx)},
                   wrap=ndarray)


def hamming(M, dtype=None, ctx=None):  # noqa: N803
    return _invoke("_npi_hamming", [], {"M": int(M),
                                        "device": _device(ctx)},
                   wrap=ndarray)


def blackman(M, dtype=None, ctx=None):  # noqa: N803
    return _invoke("_npi_blackman", [], {"M": int(M),
                                         "device": _device(ctx)},
                   wrap=ndarray)


def polyval(p, x):
    return _invoke("_npi_polyval", [_as_np(p), _as_np(x)], {}, wrap=ndarray)


def ediff1d(ary, to_end=None, to_begin=None):
    kw = {}
    if to_end is not None:
        kw["to_end"] = float(to_end)
    if to_begin is not None:
        kw["to_begin"] = float(to_begin)
    return _invoke("_npi_ediff1d", [_as_np(ary)], kw, wrap=ndarray)


def delete(arr, obj, axis=None):
    if isinstance(obj, slice):
        return _invoke("_npi_delete", [_as_np(arr)],
                       {"start": obj.start, "stop": obj.stop,
                        "step": obj.step, "axis": axis}, wrap=ndarray)
    if isinstance(obj, (int, _onp.integer)):
        return _invoke("_npi_delete", [_as_np(arr)],
                       {"obj": int(obj), "axis": axis}, wrap=ndarray)
    return _invoke("_npi_delete", [_as_np(arr)],
                   {"obj": _as_np(obj, ctx=_as_np(arr).context)._data,
                    "axis": axis}, wrap=ndarray)


def insert(arr, obj, values, axis=None):
    if isinstance(obj, slice):
        return _invoke("_npi_insert_slice", [_as_np(arr), _as_np(values)],
                       {"start": obj.start, "stop": obj.stop,
                        "step": obj.step, "axis": axis}, wrap=ndarray)
    if isinstance(obj, (int, _onp.integer)) and _onp.isscalar(values):
        return _invoke("_npi_insert_scalar", [_as_np(arr)],
                       {"obj": int(obj), "val": values, "axis": axis},
                       wrap=ndarray)
    ctx = _as_np(arr).context
    return _invoke("_npi_insert_tensor",
                   [_as_np(arr), _as_np(obj, ctx=ctx),
                    _as_np(values, ctx=ctx)], {"axis": axis}, wrap=ndarray)


def diag_indices_from(arr):
    return _invoke("_npi_diag_indices_from", [_as_np(arr)], {},
                   wrap=ndarray)


def deg2rad(x):
    return _invoke("_npi_deg2rad", [_as_np(x)], {}, wrap=ndarray)


def rad2deg(x):
    return _invoke("_npi_rad2deg", [_as_np(x)], {}, wrap=ndarray)


def bitwise_not(x):
    return _invoke("_npi_bitwise_not", [_as_np(x)], {}, wrap=ndarray)


def around(x, decimals=0):
    if decimals:
        return _invoke("_npi_round", [_as_np(x)], {"decimals": decimals},
                       wrap=ndarray)
    return _invoke("_npi_around", [_as_np(x)], {}, wrap=ndarray)


round = around  # noqa: A001
round_ = around
