"""NumPy-frontend ops: the ``_npi_*``, ``_np_*`` and ``_npx_*`` names.

Counterpart of ``mxnet_tpu/ops/numpy_ops.py``, name for name (271 names,
with each op's keyword parameters as the JAX emitter declares them, so
the schemas of ``ops/schema.py`` and their messages agree). ``mx.np``,
``mx.npx`` and the symbol layer reach them through the registry.

Numbers and dtypes are the JAX package's, which runs with 64-bit types
off: integer results are int32 where jnp gives int32 (sums, cumulative
sums and products of bool and small integers, ``argmax``/``argsort``,
``searchsorted``, ``count_nonzero``, the index ops), a transcendental
op of an integer or bool array is float32, comparisons are bool, and a
Python scalar is weakly typed (an int32 array plus 2 stays int32, plus
2.5 is float32, bool plus 2 is int32). Where numpy differs (int64
indices, float64 means of integers) the JAX package is followed. An
int64 or float64 tensor given explicitly keeps its width. Divisions by a
Python number divide by a 0-d tensor on the operand's device, not by a
reciprocal, so the card and the CPU agree bit for bit.

Nine ops read their data on the host, as the JAX package runs them
eagerly (``eager=True``): ``_npi_unique``, ``_npi_nonzero``,
``_npx_nonzero``, ``_npi_bincount`` (their output's shape is the data's),
``_npi_delete``, the three ``_npi_insert_*`` (numpy's ``delete`` and
``insert`` on a host copy) and ``_npi_share_memory``. They are host ops
(``registry.register(host=True)``): a body that calls one runs
uncaptured. The boolean-mask assignments keep their input's shape and
run on the device with no host read.

The samplers take the port's runtime ``generator`` and ``device`` (by
default ``mx.random``'s generator of the current context's device)
where the JAX ops take a threefry ``key``; ``key`` stays in their
signatures for the schema. Draws repeat under ``mx.random.seed`` and
differ from the JAX package's by value (C28's rule).

The linear-algebra ops run ``torch.linalg``, as ``la_op.py`` does;
``_npi_eigh`` and ``_npi_eigvalsh`` go through ``linalg_syevd``'s route
and are host ops with it (cuSOLVER's status is read back).
``_npi_einsum`` is ``torch.einsum``.
"""
from __future__ import annotations

import math as _math

import numpy as _np
import torch

from .. import random as _random
from ..base import canonical_dtype
from ..context import Context, current_context
from .registry import alias as _alias
from .registry import register

__all__ = []

_SMALL_INT = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32)


def _reg_fixed(name, fn, num_outputs=1, differentiable=True, host=False):
    register(name, num_outputs=num_outputs, differentiable=differentiable,
             host=host)(fn)


def _inexact(x):
    """``x``, or its float32 copy when it is bool or integer (jnp's
    promotion to an inexact type with 64-bit types off)."""
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float32)


def _acc(x):
    """The dtype jnp sums ``x`` in: int32 for bool and small integers."""
    return torch.int32 if x.dtype in _SMALL_INT else x.dtype


def _i32(x):
    """An index result in jnp's int32 (64-bit types off)."""
    return x.to(torch.int32)


def _dims(x, axis):
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) % max(x.ndim, 1) for a in axis)
    return (int(axis) % max(x.ndim, 1),)


def _device(device=None, ctx=None):
    if device is not None:
        return torch.device(device)
    if isinstance(ctx, Context):
        return ctx.torch_device()
    return current_context().torch_device()


def _dt(dtype, default="float32"):
    return canonical_dtype(default if dtype is None else dtype)


def _scalar_like(x, s, dtype=None):
    """Python number ``s`` as a 0-d tensor on ``x``'s device."""
    return torch.full((), s, dtype=dtype or x.dtype, device=x.device)


# ---------------------------------------------------------------- unary ----
def _promoting(fn):
    return lambda x: fn(_inexact(x))


def _keep_bool(fn):
    # floor/ceil/trunc of an integer or bool array is itself in jnp
    return lambda x: x if not x.is_floating_point() else fn(x)


def _square(x):
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return x * x


def _cbrt(x):
    x = _inexact(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _real(x):
    return torch.real(x) if x.is_complex() else x


def _abs(x):
    return x if x.dtype == torch.bool else torch.abs(x)


_UNARY = {
    "negative": torch.negative, "reciprocal": _promoting(torch.reciprocal),
    "absolute": _abs, "sign": torch.sign,
    "rint": _promoting(torch.round), "ceil": _keep_bool(torch.ceil),
    "floor": _keep_bool(torch.floor), "trunc": _keep_bool(torch.trunc),
    "fix": _keep_bool(torch.trunc), "square": _square,
    "sqrt": _promoting(torch.sqrt), "cbrt": _cbrt,
    "exp": _promoting(torch.exp), "expm1": _promoting(torch.expm1),
    "log": _promoting(torch.log), "log10": _promoting(torch.log10),
    "log2": _promoting(torch.log2), "log1p": _promoting(torch.log1p),
    "sin": _promoting(torch.sin), "cos": _promoting(torch.cos),
    "tan": _promoting(torch.tan), "arcsin": _promoting(torch.asin),
    "arccos": _promoting(torch.acos), "arctan": _promoting(torch.atan),
    "sinh": _promoting(torch.sinh), "cosh": _promoting(torch.cosh),
    "tanh": _promoting(torch.tanh), "arcsinh": _promoting(torch.asinh),
    "arccosh": _promoting(torch.acosh), "arctanh": _promoting(torch.atanh),
    "degrees": _promoting(torch.rad2deg),
    "radians": _promoting(torch.deg2rad),
    "invert": torch.bitwise_not, "logical_not": torch.logical_not,
    "isnan": torch.isnan, "isinf": torch.isinf, "isposinf": torch.isposinf,
    "isneginf": torch.isneginf, "isfinite": torch.isfinite,
    "conj": lambda x: torch.conj(x) if x.is_complex() else x,
    "real": _real, "imag": _imag,
}
_NONDIFF_UNARY = {"invert", "logical_not", "isnan", "isinf", "isposinf",
                  "isneginf", "isfinite", "sign", "rint", "ceil", "floor",
                  "trunc", "fix"}


# Each emitter takes the parameters of the jnp function the JAX op is, so
# the schemas (and their messages) agree: numpy's ``out``/``where`` of a
# ufunc, the XLA ``precision`` keywords of the products. Those accept
# their defaults only.
def _defaults_only(**kw):
    bad = {k: v for k, v in kw.items() if v is not None}
    if bad:
        raise NotImplementedError(
            f"keyword(s) {sorted(bad)} are accepted with their default "
            "only")


def _sig_ufunc(fn):
    def op(*args, out=None, where=None):
        _defaults_only(out=out, where=where)
        return fn(*args)

    return op


def _sig_x(fn):
    return lambda x: fn(x)


def _sig_x_out(fn):
    def op(x, out=None):
        _defaults_only(out=out)
        return fn(x)

    return op


def _sig_val(fn):
    return lambda val: fn(val)


def _sig_x12(fn):
    return lambda x1, x2: fn(x1, x2)


def _sig_xy(fn):
    return lambda x, y: fn(x, y)


def _sig_ab(fn):
    return lambda a, b: fn(a, b)


def _sig_ab_out(fn):
    def op(a, b, out=None):
        _defaults_only(out=out)
        return fn(a, b)

    return op


def _sig_product(fn, sharding=True):
    def op(a, b, precision=None, preferred_element_type=None,
           out_sharding=None):
        _defaults_only(precision=precision,
                       preferred_element_type=preferred_element_type,
                       out_sharding=out_sharding)
        return fn(a, b)

    def op2(a, b, precision=None, preferred_element_type=None):
        _defaults_only(precision=precision,
                       preferred_element_type=preferred_element_type)
        return fn(a, b)

    return op if sharding else op2


_UFUNC_NAMES = {"negative", "add", "subtract", "multiply", "maximum",
                "minimum", "logaddexp", "bitwise_and", "bitwise_or",
                "bitwise_xor", "logical_and", "logical_or", "logical_xor"}
_XY_NAMES = {"left_shift", "equal", "not_equal", "less", "less_equal",
             "greater", "greater_equal"}


def _unary_sig(name, fn):
    if name in _UFUNC_NAMES:
        return _sig_ufunc(fn)
    if name in ("isposinf", "isneginf"):
        return _sig_x_out(fn)
    if name in ("real", "imag"):
        return _sig_val(fn)
    return _sig_x(fn)


for _name, _fn in _UNARY.items():
    _reg_fixed(f"_npi_{_name}", _unary_sig(_name, _fn),
               differentiable=_name not in _NONDIFF_UNARY)


# --------------------------------------------------------------- binary ----
def _true_divide(a, b):
    return torch.true_divide(_inexact(a), b)


def _bool_to_int(fn):
    # jnp sums, divides and raises bool operands as int32
    def op(a, b):
        if a.dtype == torch.bool and b.dtype == torch.bool:
            a = a.to(torch.int32)
        return fn(a, b)

    return op


def _float_binary(fn):
    def op(a, b):
        dt = torch.promote_types(_inexact(a).dtype, _inexact(b).dtype)
        return fn(a.to(dt), b.to(dt))

    return op


def _floor_divide(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _promoted(fn):
    """``fn`` on both operands cast to their promoted dtype (bool with
    an integer is the integer, as in jnp)."""
    def op(a, b):
        dt = torch.promote_types(a.dtype, b.dtype)
        return fn(a.to(dt), b.to(dt))

    return op


def _product(fn):
    # jnp's products promote their operands; a bool product is the
    # logical one
    def op(a, b):
        dt = torch.promote_types(a.dtype, b.dtype)
        if dt == torch.bool:
            return fn(a.to(torch.int32), b.to(torch.int32)) != 0
        return fn(a.to(dt), b.to(dt))

    return op


def _minmax(fn):
    def op(a, b):
        if a.dtype == torch.bool and b.dtype == torch.bool:
            return fn(a.to(torch.int32), b.to(torch.int32)).bool()
        return fn(a, b)

    return op


def _dot(a, b):
    """numpy's ``dot``: a product with a 0-d operand, the inner product
    of vectors, else a sum over ``a``'s last and ``b``'s second-to-last
    axis."""
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if b.ndim == 1:
        return torch.tensordot(a, b, dims=([-1], [0]))
    return torch.tensordot(a, b, dims=([-1], [b.ndim - 2]))


def _cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    if axis is not None:
        axisa = axisb = axisc = axis
    a, b = torch.movedim(a, axisa, -1), torch.movedim(b, axisb, -1)
    if a.shape[-1] == 2 and b.shape[-1] == 2:
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    a, b = torch.broadcast_tensors(a, b)
    return torch.movedim(torch.linalg.cross(a, b, dim=-1), -1, axisc)


_matmul = _product(torch.matmul)


_BINARY = {
    "add": torch.add,
    "subtract": _promoted(torch.subtract), "multiply": torch.multiply,
    "true_divide": _true_divide,
    "floor_divide": _bool_to_int(_floor_divide),
    "mod": _bool_to_int(torch.remainder), "fmod": _bool_to_int(torch.fmod),
    "remainder": _bool_to_int(torch.remainder),
    "power": _bool_to_int(torch.pow), "maximum": _minmax(torch.maximum),
    "minimum": _minmax(torch.minimum), "fmax": _minmax(torch.fmax),
    "fmin": _minmax(torch.fmin), "hypot": _float_binary(torch.hypot),
    "arctan2": _float_binary(torch.atan2),
    "copysign": _float_binary(torch.copysign),
    "ldexp": lambda a, b: torch.ldexp(_inexact(a), b.to(torch.int32)
                                      if b.dtype == torch.bool else b),
    "logaddexp": _float_binary(torch.logaddexp),
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "left_shift": _bool_to_int(torch.bitwise_left_shift),
    "right_shift": _bool_to_int(torch.bitwise_right_shift),
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
    "equal": torch.eq, "not_equal": torch.ne, "less": torch.lt,
    "less_equal": torch.le, "greater": torch.gt,
    "greater_equal": torch.ge,
    "matmul": _matmul, "dot": _product(_dot),
    "inner": _product(torch.inner),
    "outer": lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
    "kron": torch.kron, "cross": _cross, "gcd": torch.gcd,
    "lcm": torch.lcm,
}
_NONDIFF_BIN = {"bitwise_and", "bitwise_or", "bitwise_xor", "left_shift",
                "right_shift", "logical_and", "logical_or", "logical_xor",
                "equal", "not_equal", "less", "less_equal", "greater",
                "greater_equal", "gcd", "lcm", "floor_divide"}
def _binary_sig(name, fn):
    if name in _UFUNC_NAMES:
        return _sig_ufunc(fn)
    if name in _XY_NAMES:
        return _sig_xy(fn)
    if name in ("matmul", "dot"):
        return _sig_product(fn)
    if name == "inner":
        return _sig_product(fn, sharding=False)
    if name == "outer":
        return _sig_ab_out(fn)
    if name in ("kron", "cross"):
        return fn if name == "cross" else _sig_ab(fn)
    return _sig_x12(fn)


for _name, _fn in _BINARY.items():
    _reg_fixed(f"_npi_{_name}", _binary_sig(_name, _fn),
               differentiable=_name not in _NONDIFF_BIN)


# scalar variants (the scalar a keyword, like the legacy _*_scalar ops)
def _with_scalar(data, scalar):
    """``(data, scalar tensor)`` in jnp's weak-type promotion: a bool
    array meets an int as int32, an integer array meets a float as
    float32."""
    if isinstance(scalar, bool):
        dt = data.dtype
    elif isinstance(scalar, int):
        dt = torch.int32 if data.dtype == torch.bool else data.dtype
    else:
        dt = data.dtype if data.is_floating_point() else torch.float32
    return data.to(dt), _scalar_like(data, scalar, dt)


def _scalar_fn(base, rev):
    fn = _BINARY[base]

    def op(data, scalar=0.0):
        d, s = _with_scalar(data, scalar)
        return fn(s, d) if rev else fn(d, s)

    return op


for _name in ("add", "subtract", "rsubtract", "multiply", "true_divide",
              "rtrue_divide", "mod", "rmod", "power", "rpower",
              "floor_divide", "rfloor_divide"):
    _base = _name[1:] if _name.startswith("r") else _name
    _reg_fixed(f"_npi_{_name}_scalar", _scalar_fn(_base, _name.startswith("r")),
               differentiable=_base != "floor_divide")


# ----------------------------------------------------------- reductions ----
def _cast(out, dtype):
    return out if dtype is None else out.to(canonical_dtype(dtype))


def _sum(a, axis=None, dtype=None, keepdims=False):
    out = torch.sum(a, dim=_dims(a, axis), keepdim=keepdims,
                    dtype=_acc(a) if dtype is None else canonical_dtype(dtype))
    return out


def _prod(a, axis=None, dtype=None, keepdims=False):
    dt = _acc(a) if dtype is None else canonical_dtype(dtype)
    out = a.to(dt)
    for d in sorted(_dims(a, axis), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims, dtype=dt)
    return out


def _mean(a, axis=None, dtype=None, keepdims=False):
    out = torch.mean(_inexact(a), dim=_dims(a, axis), keepdim=keepdims)
    return _cast(out, dtype)


def _std(a, axis=None, ddof=0, keepdims=False):
    return torch.std(_inexact(a), dim=_dims(a, axis), correction=ddof,
                     keepdim=keepdims)


def _var(a, axis=None, ddof=0, keepdims=False):
    return torch.var(_inexact(a), dim=_dims(a, axis), correction=ddof,
                     keepdim=keepdims)


def _np_reduce(fn):
    def op(a, axis=None, keepdims=False, dtype=None):
        x = a.to(torch.int32) if a.dtype == torch.bool else a
        out = fn(x, dim=_dims(a, axis), keepdim=keepdims)
        out = out.bool() if a.dtype == torch.bool else out
        return _cast(out, dtype)

    return op


def _arg(fn):
    def op(a, axis=None, keepdims=False):
        x = a.to(torch.int32) if a.dtype == torch.bool else a
        if axis is None:
            out = fn(x.reshape(-1), dim=0)
            if keepdims:
                out = out.reshape((1,) * a.ndim)
            return _i32(out)
        return _i32(fn(x, dim=int(axis), keepdim=keepdims))

    return op


def _any(a, axis=None, keepdims=False):
    out = a.bool()
    for d in sorted(_dims(a, axis), reverse=True):
        out = torch.any(out, dim=d, keepdim=keepdims)
    return out


def _all(a, axis=None, keepdims=False):
    out = a.bool()
    for d in sorted(_dims(a, axis), reverse=True):
        out = torch.all(out, dim=d, keepdim=keepdims)
    return out


def _cum(fn):
    def op(a, axis=None, dtype=None):
        x = a.reshape(-1) if axis is None else a
        out = fn(x, dim=0 if axis is None else int(axis),
                 dtype=_acc(a) if dtype is None else canonical_dtype(dtype))
        return out

    return op


def _nansum(a, axis=None, dtype=None, keepdims=False):
    if not a.is_floating_point():
        return _sum(a, axis=axis, dtype=dtype, keepdims=keepdims)
    out = torch.nansum(a, dim=_dims(a, axis), keepdim=keepdims)
    return _cast(out, dtype)


def _nanprod(a, axis=None, dtype=None, keepdims=False):
    x = torch.where(torch.isnan(a), torch.ones_like(a), a) \
        if a.is_floating_point() else a
    return _prod(x, axis=axis, dtype=dtype, keepdims=keepdims)


def _moved(a, axis):
    """``a`` with the reduced axes last and flattened into one, and the
    shape a ``keepdims`` result takes."""
    dims = _dims(a, axis)
    keep = [d for d in range(a.ndim) if d not in dims]
    x = a.permute(keep + list(dims)).reshape(
        [a.shape[d] for d in keep] + [-1])
    kshape = [1 if d in dims else a.shape[d] for d in range(a.ndim)]
    return x, kshape


def _median(a, axis=None, keepdims=False):
    x, kshape = _moved(_inexact(a), axis)
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    mid = s[..., n // 2] if n % 2 else \
        (s[..., n // 2 - 1] + s[..., n // 2]) / 2
    return mid.reshape(kshape) if keepdims else mid


def _quantile_q(a, q, axis=None, keepdims=False):
    x, kshape = _moved(_inexact(a), axis)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    out = torch.quantile(x, qt, dim=-1)
    if qt.ndim == 0:
        return out.reshape(kshape) if keepdims else out
    return out.reshape(qt.shape + tuple(kshape)) if keepdims else out


def _quantile(a, q=0.5, axis=None, keepdims=False):
    return _quantile_q(a, q, axis, keepdims)


def _percentile(a, q=50.0, axis=None, keepdims=False):
    q = _np.asarray(q, dtype=_np.float64) / 100.0
    return _quantile_q(a, q.tolist(), axis, keepdims)


def _average(a, weights=None, axis=None):
    if weights is None:
        return _mean(a, axis=axis)
    a = _inexact(a)
    w = torch.as_tensor(weights, device=a.device).to(a.dtype)
    if w.shape != a.shape and axis is not None:
        shape = [1] * a.ndim
        shape[int(axis)] = -1
        w = w.reshape(shape)
    w = torch.broadcast_to(w, a.shape)
    dims = _dims(a, axis)
    return torch.sum(a * w, dim=dims) / torch.sum(w, dim=dims)


def _ptp(a, axis=None, keepdims=False):
    dims = _dims(a, axis)
    return torch.amax(a, dim=dims, keepdim=keepdims) - \
        torch.amin(a, dim=dims, keepdim=keepdims)


def _count_nonzero(a, axis=None, keepdims=False):
    out = (a != 0).to(torch.int32)
    return torch.sum(out, dim=_dims(a, axis), keepdim=keepdims,
                     dtype=torch.int32)


_reg_fixed("_npi_sum", _sum)
_reg_fixed("_npi_prod", _prod)
_reg_fixed("_npi_mean", _mean)
_reg_fixed("_npi_std", _std)
_reg_fixed("_npi_var", _var)
_reg_fixed("_npi_max", _np_reduce(torch.amax))
_reg_fixed("_npi_min", _np_reduce(torch.amin))
_reg_fixed("_npi_amax", _np_reduce(torch.amax))
_reg_fixed("_npi_amin", _np_reduce(torch.amin))
_reg_fixed("_npi_argmax", _arg(torch.argmax), differentiable=False)
_reg_fixed("_npi_argmin", _arg(torch.argmin), differentiable=False)
_reg_fixed("_npi_any", _any, differentiable=False)
_reg_fixed("_npi_all", _all, differentiable=False)
_reg_fixed("_npi_cumsum", _cum(torch.cumsum))
_reg_fixed("_npi_cumprod", _cum(torch.cumprod))
_reg_fixed("_npi_nansum", _nansum)
_reg_fixed("_npi_nanprod", _nanprod)
_reg_fixed("_npi_median", _median)
_reg_fixed("_npi_quantile", _quantile)
_reg_fixed("_npi_percentile", _percentile)
_reg_fixed("_npi_average", _average)
_reg_fixed("_npi_ptp", _ptp)
_reg_fixed("_npi_count_nonzero", _count_nonzero, differentiable=False)


# ----------------------------------------------------------- shape/move ----
def _shape_arg(shape):
    return (int(shape),) if isinstance(shape, (int, _np.integer)) else \
        tuple(int(s) for s in shape)


def _reshape(a, newshape=(), order="C"):
    return torch.reshape(a, _shape_arg(newshape))


def _transpose(a, axes=None):
    if not axes:
        return a.permute(tuple(range(a.ndim - 1, -1, -1)))
    return a.permute(tuple(axes))


def _expand_dims(a, axis=0):
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    n = a.ndim + len(axes)
    out = a
    for ax in sorted(int(x) % n for x in axes):
        out = out.unsqueeze(ax)
    return out


def _squeeze(a, axis=None):
    if axis is None:
        return torch.squeeze(a)
    return torch.squeeze(a, dim=_dims(a, axis))


def _flip(a, axis=None):
    return torch.flip(a, dims=_dims(a, axis))


def _roll(a, shift=0, axis=None):
    if axis is None:
        return torch.roll(a.reshape(-1), shifts=shift).reshape(a.shape)
    return torch.roll(a, shifts=shift, dims=axis)


def _repeat(a, repeats=1, axis=None):
    if not isinstance(repeats, int):
        repeats = torch.as_tensor(repeats, device=a.device)
    if axis is None:
        return torch.repeat_interleave(a.reshape(-1), repeats)
    return torch.repeat_interleave(a, repeats, dim=int(axis))


def _pad_widths(pad_width, ndim):
    pw = _np.broadcast_to(_np.asarray(pad_width, dtype=_np.int64)
                          .reshape(-1, 2) if _np.ndim(pad_width) > 0
                          else _np.asarray([[pad_width, pad_width]]),
                          (ndim, 2))
    return [(int(b), int(e)) for b, e in pw]


def _pad_index(n, before, after, mode, device):
    """numpy's source index of each output position along one axis."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "reflect":
        period = 2 * (n - 1) if n > 1 else 1
        j = torch.remainder(i, period)
        return torch.where(j >= n, period - j, j)
    if mode == "symmetric":
        j = torch.remainder(i, 2 * n)
        return torch.where(j >= n, 2 * n - 1 - j, j)
    raise ValueError(f"pad mode {mode!r} is not supported")


def _pad(a, pad_width=(), mode="constant", constant_values=0):
    widths = _pad_widths(pad_width, a.ndim)
    if mode == "constant":
        flat = [w for b, e in reversed(widths) for w in (b, e)]
        return torch.nn.functional.pad(a, flat, value=constant_values)
    out = a
    for d, (b, e) in enumerate(widths):
        if b or e:
            out = torch.index_select(
                out, d, _pad_index(out.shape[d], b, e, mode, a.device))
    return out


def _trace(a, offset=0, axis1=0, axis2=1):
    d = torch.diagonal(a, offset=offset, dim1=axis1, dim2=axis2)
    return torch.sum(d, dim=-1, dtype=_acc(a))


_reg_fixed("_npi_reshape", _reshape)
_reg_fixed("_npi_transpose", _transpose)
_reg_fixed("_npi_swapaxes", lambda a, dim1=0, dim2=1:
           torch.swapaxes(a, dim1, dim2))
_reg_fixed("_npi_moveaxis", lambda a, source=0, destination=0:
           torch.movedim(a, source, destination))
_reg_fixed("_npi_expand_dims", _expand_dims)
_reg_fixed("_npi_squeeze", _squeeze)
_reg_fixed("_npi_broadcast_to", lambda a, shape=():
           torch.broadcast_to(a, _shape_arg(shape)))
_reg_fixed("_npi_ravel", lambda a: torch.reshape(a, (-1,)))
_reg_fixed("_npi_flip", _flip)
_reg_fixed("_npi_fliplr", lambda m: torch.flip(m, dims=(1,)))
_reg_fixed("_npi_flipud", lambda m: torch.flip(m, dims=(0,)))
_reg_fixed("_npi_roll", _roll)
_reg_fixed("_npi_rot90", lambda a, k=1, axes=(0, 1):
           torch.rot90(a, k, dims=tuple(axes)))
_reg_fixed("_npi_tile", lambda a, reps=(): torch.tile(
    a, (int(reps),) if isinstance(reps, int) else tuple(reps)))
_reg_fixed("_npi_repeat", _repeat)
_reg_fixed("_npi_pad", _pad)
_reg_fixed("_npi_diag", lambda a, k=0: torch.diag(a, k))
_reg_fixed("_npi_diagonal", lambda a, offset=0, axis1=0, axis2=1:
           torch.diagonal(a, offset=offset, dim1=axis1, dim2=axis2))
_reg_fixed("_npi_diagflat", lambda a, k=0: torch.diagflat(a, k))
_reg_fixed("_npi_tril", lambda a, k=0: torch.tril(a, k))
_reg_fixed("_npi_triu", lambda a, k=0: torch.triu(a, k))
_reg_fixed("_npi_trace", _trace)


# ---------------------------------------------------------- combination ----
def _concatenate(*arrays, axis=0):
    if axis is None:
        return torch.cat([a.reshape(-1) for a in arrays])
    return torch.cat(arrays, dim=axis)


def _np_split(a, indices_or_sections=1, axis=0, even=True):
    ios = indices_or_sections
    n = a.shape[axis]
    if isinstance(ios, (int, _np.integer)):
        if even and n % int(ios):
            raise ValueError("array split does not result in an equal "
                             "division")
        return tuple(torch.tensor_split(a, int(ios), dim=axis))
    return tuple(torch.tensor_split(a, [int(i) for i in ios], dim=axis))


def _take(a, indices, axis=None, mode="clip"):
    src = a.reshape(-1) if axis is None else a
    dim = 0 if axis is None else int(axis) % a.ndim
    n = src.shape[dim]
    idx = indices.long()
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(src, dim, idx.reshape(-1))
    return out.reshape(src.shape[:dim] + tuple(indices.shape)
                       + src.shape[dim + 1:])


def _take_along_axis(a, indices, axis=0):
    return torch.take_along_dim(a, indices.long(), dim=axis)


def _searchsorted(a, v, side="left"):
    return _i32(torch.searchsorted(a, v.to(a.dtype), right=side == "right"))


def _unique(a, size=None):
    out = torch.unique(a.reshape(-1), sorted=True)
    if size is not None:
        size = int(size)
        if out.numel() >= size:
            return out[:size]
        pad = out[:1].expand(size - out.numel())
        return torch.cat([out, pad])
    return out


def _nonzero(a):
    return tuple(_i32(i) for i in torch.nonzero(a, as_tuple=True))


def _bincount(a, weights=None, minlength=0):
    x = a.reshape(-1).long()
    if weights is None:
        return _i32(torch.bincount(x, minlength=int(minlength)))
    w = torch.as_tensor(weights, device=a.device).reshape(-1)
    return torch.bincount(x, weights=_inexact(w),
                          minlength=int(minlength)).to(_inexact(w).dtype)


def _linspace_t(start, stop, num, dtype, device, endpoint=True):
    """jnp.linspace's formula, with tensor or number endpoints:
    ``start * (1 - t) + stop * t`` for ``t = i / div`` (float32 division),
    ``stop`` itself appended at an endpoint."""
    div = num - 1 if endpoint else num
    start = torch.as_tensor(start, dtype=dtype, device=device)
    stop = torch.as_tensor(stop, dtype=dtype, device=device)
    if num <= 1:
        return start.reshape(1)[:num]
    t = torch.arange(div, dtype=dtype, device=device) / \
        torch.full((), div, dtype=dtype, device=device)
    out = start * (1 - t) + stop * t
    return torch.cat([out, stop.reshape(1)]) if endpoint else out


def _histogram(a, bins=10, range=None):
    x = _inexact(a).reshape(-1)
    if range is None:
        lo, hi = torch.amin(x), torch.amax(x)
    else:
        lo = torch.tensor(float(range[0]), dtype=x.dtype, device=x.device)
        hi = torch.tensor(float(range[1]), dtype=x.dtype, device=x.device)
    hi = torch.where(hi == lo, hi + 1, hi) if range is None else hi
    if isinstance(bins, int):
        edges = _linspace_t(lo, hi, bins + 1, x.dtype, x.device)
    else:
        edges = torch.as_tensor(bins, device=x.device).to(x.dtype)
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], edges.numel() - 1, idx)
    counts = torch.zeros(edges.numel(), dtype=x.dtype, device=x.device)
    counts = counts.scatter_add(0, idx, torch.ones_like(x))
    return counts[1:], edges


def _interp(x, xp, fp, left=None, right=None, period=None):
    x = _inexact(x)
    xp = xp.to(x.dtype)
    fp = _inexact(fp)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = torch.where(dx == 0, fp[i],
                    fp[i - 1] + (delta / torch.where(dx == 0,
                                                     torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0] if left is None else left, f)
    return torch.where(x > xp[-1], fp[-1] if right is None else right, f)


def _round(a, decimals=0):
    if not a.is_floating_point():
        return a
    if decimals == 0:
        return torch.round(a)
    scale = _scalar_like(a, 10.0 ** decimals)
    return torch.round(a * scale) / scale


def _meshgrid(*arrays, indexing="xy"):
    return tuple(torch.meshgrid(*[t.reshape(-1) for t in arrays],
                                indexing=indexing))


def _tril_indices(n=1, k=0, m=None, device=None):
    return _i32(torch.tril_indices(int(n), int(n if m is None else m), int(k),
                                   device=_device(device)))


def _indices(dimensions=(), dtype="int32", device=None):
    dev = _device(device)
    grids = torch.meshgrid(*[torch.arange(int(d), device=dev)
                             for d in dimensions], indexing="ij")
    if not grids:
        return torch.zeros((0,), dtype=canonical_dtype(dtype), device=dev)
    return torch.stack(grids).to(canonical_dtype(dtype))


def _gradient_op(a, axis=None):
    dims = _dims(a, axis)
    out = torch.gradient(_inexact(a), dim=list(dims))
    return tuple(out) if len(out) > 1 else out[0]


_reg_fixed("_npi_concatenate", _concatenate)
_reg_fixed("_npi_stack", lambda *arrays, axis=0: torch.stack(arrays, dim=axis))
_reg_fixed("_npi_vstack", lambda *arrays: torch.vstack(arrays))
_reg_fixed("_npi_hstack", lambda *arrays: torch.hstack(arrays))
_reg_fixed("_npi_dstack", lambda *arrays: torch.dstack(arrays))
_reg_fixed("_npi_column_stack", lambda *arrays: torch.column_stack(arrays))
_reg_fixed("_npi_atleast_1d", lambda *arys: torch.atleast_1d(*arys))
_reg_fixed("_npi_atleast_2d", lambda *arys: torch.atleast_2d(*arys))
_reg_fixed("_npi_atleast_3d", lambda *arys: torch.atleast_3d(*arys))
_reg_fixed("_npi_split", lambda a, indices_or_sections=1, axis=0:
           _np_split(a, indices_or_sections, axis), num_outputs=2)
_reg_fixed("_npi_array_split", lambda a, indices_or_sections=1, axis=0:
           _np_split(a, indices_or_sections, axis, even=False),
           num_outputs=2)
def _where(condition, x=None, y=None, size=None, fill_value=None):
    _defaults_only(size=size, fill_value=fill_value)
    return torch.where(condition.bool(), x, y)


_reg_fixed("_npi_where", _where)
_reg_fixed("_npi_clip", lambda a, a_min=None, a_max=None:
           a if a_min is None and a_max is None else
           torch.clamp(a, a_min, a_max))
_reg_fixed("_npi_take", _take)
_reg_fixed("_npi_take_along_axis", _take_along_axis)
_reg_fixed("_npi_searchsorted", _searchsorted, differentiable=False)
_reg_fixed("_npi_sort", lambda a, axis=-1:
           torch.sort(a, dim=axis, stable=True).values)
_reg_fixed("_npi_argsort", lambda a, axis=-1:
           _i32(torch.argsort(a, dim=axis, stable=True)),
           differentiable=False)
# data-dependent output shapes: host ops (the JAX ops' eager=True)
_reg_fixed("_npi_unique", _unique, differentiable=False, host=True)
_reg_fixed("_npi_nonzero", _nonzero, num_outputs=2, differentiable=False,
           host=True)
_reg_fixed("_npi_bincount", _bincount, differentiable=False, host=True)
_reg_fixed("_npi_histogram", _histogram, num_outputs=2, differentiable=False)
_reg_fixed("_npi_interp", _interp)
_reg_fixed("_npi_nan_to_num", lambda a, nan=0.0, posinf=None, neginf=None:
           torch.nan_to_num(a, nan=nan, posinf=posinf, neginf=neginf)
           if a.is_floating_point() else a)
_reg_fixed("_npi_round", _round)
_reg_fixed("_npi_sign_nd", lambda x: torch.sign(x), differentiable=False)
_reg_fixed("_npi_meshgrid", _meshgrid, num_outputs=2)
_reg_fixed("_npi_tril_indices", _tril_indices, differentiable=False)
_reg_fixed("_npi_indices", _indices, differentiable=False)
_reg_fixed("_npi_diff", lambda a, n=1, axis=-1: torch.diff(a, n=n, dim=axis))
_reg_fixed("_npi_gradient_op", _gradient_op)


# ------------------------------------------------------ einsum/tensordot ----
def _einsum(*operands, subscripts=""):
    return torch.einsum(subscripts, *operands)


def _tensordot(a, b, axes=2):
    if isinstance(axes, (int, _np.integer)):
        return torch.tensordot(a, b, dims=int(axes))
    ax_a, ax_b = axes
    ax_a = [ax_a] if isinstance(ax_a, int) else list(ax_a)
    ax_b = [ax_b] if isinstance(ax_b, int) else list(ax_b)
    return torch.tensordot(a, b, dims=(ax_a, ax_b))


_reg_fixed("_npi_einsum", _einsum)
_reg_fixed("_npi_tensordot", _tensordot)
_reg_fixed("_npi_vdot", _sig_product(
    lambda a, b: torch.vdot(a.reshape(-1), b.reshape(-1)), sharding=False))
_reg_fixed("_npi_tensordot_int_axes", lambda a, b, axes=2:
           torch.tensordot(a, b, dims=int(axes)))


# ---------------------------------------------------------------- linalg ----
def _norm(a, ord=None, axis=None, keepdims=False):
    a = _inexact(a)
    if axis is None and ord is None:
        out = torch.linalg.vector_norm(a.reshape(-1))
        return out.reshape((1,) * a.ndim) if keepdims else out
    if isinstance(axis, (tuple, list)) and len(axis) == 1:
        axis = axis[0]
    return torch.linalg.norm(a, ord=ord, dim=axis, keepdim=keepdims)


def _eigh(a, UPLO="L"):  # noqa: N803 - numpy's name
    from .registry import get

    vt, w = get("linalg_syevd")(a if UPLO == "L" else a.transpose(-1, -2))
    return w, vt.transpose(-1, -2)


def _lstsq(a, b, rcond=None):
    x = torch.linalg.lstsq(a, b, rcond=rcond).solution
    m, n = a.shape[-2], a.shape[-1]
    s = torch.linalg.svdvals(a)
    tol = (s.amax(-1, keepdim=True) * max(m, n)
           * torch.finfo(s.dtype).eps) if rcond is None else \
        s.amax(-1, keepdim=True) * rcond
    rank = (s > tol).sum(-1).to(torch.int32)
    resid = torch.sum((b - a @ x) ** 2, dim=-2) if m > n else \
        torch.zeros((0,), dtype=x.dtype, device=x.device)
    return x, resid, rank, s


def _pinv(a, rcond=1e-15):
    return torch.linalg.pinv(a, rtol=rcond)


def _matrix_rank(a, tol=None):
    return _i32(torch.linalg.matrix_rank(a, rtol=tol))


def _slogdet(a, method=None):
    _defaults_only(method=method)
    sign, logabs = torch.linalg.slogdet(a)
    return sign, logabs


def _cholesky(a, upper=False, symmetrize_input=True):
    if symmetrize_input:
        a = (a + a.transpose(-1, -2).conj()) / 2
    out = torch.linalg.cholesky_ex(a)[0]
    return out.transpose(-1, -2).conj() if upper else out


_reg_fixed("_npi_norm", _norm)
_reg_fixed("_npi_inv", lambda a: torch.linalg.inv_ex(a)[0])
_reg_fixed("_npi_pinv", _pinv)
_reg_fixed("_npi_det", lambda a: torch.linalg.det(a))
_reg_fixed("_npi_slogdet", _slogdet, num_outputs=2)
_reg_fixed("_npi_matrix_rank", _matrix_rank, differentiable=False)
_reg_fixed("_npi_svd", lambda a: tuple(torch.linalg.svd(a)), num_outputs=3)
_reg_fixed("_npi_qr", lambda a: tuple(torch.linalg.qr(a)), num_outputs=2)
_reg_fixed("_npi_cholesky", _cholesky)
_reg_fixed("_npi_eig", lambda a: tuple(torch.linalg.eig(a)), num_outputs=2,
           differentiable=False)
# eigh reads cuSOLVER's status back: a host op, as linalg_syevd
_reg_fixed("_npi_eigh", _eigh, num_outputs=2, host=True)
_reg_fixed("_npi_eigvals", lambda a: torch.linalg.eigvals(a),
           differentiable=False)
_reg_fixed("_npi_eigvalsh", lambda a, UPLO="L": _eigh(a, UPLO)[0], host=True)
_reg_fixed("_npi_solve", lambda a, b: torch.linalg.solve_ex(a, b)[0])
_reg_fixed("_npi_lstsq", _lstsq, num_outputs=4, differentiable=False)
_reg_fixed("_npi_matrix_power", lambda a, n=1:
           torch.linalg.matrix_power(a, int(n)))
_reg_fixed("_npi_multi_dot", lambda *arrays: torch.linalg.multi_dot(arrays))


# ---------------------------------------------------------------- random ----
def _gen(device, generator):
    device = _device(device)
    return device, generator if generator is not None else \
        _random.generator(device)


def _size(size):
    return _shape_arg(size)


def _uniform(low=0.0, high=1.0, key=None, size=(), dtype="float32",
             generator=None, device=None):
    device, g = _gen(device, generator)
    out = torch.empty(_size(size), dtype=canonical_dtype(dtype),
                      device=device)
    return out.uniform_(low, high, generator=g)


def _normal(loc=0.0, scale=1.0, key=None, size=(), dtype="float32",
            generator=None, device=None):
    device, g = _gen(device, generator)
    draws = torch.randn(_size(size), dtype=canonical_dtype(dtype),
                        device=device, generator=g)
    return loc + scale * draws


def _randint(low=0, high=None, key=None, size=(), dtype="int32",
             generator=None, device=None):
    device, g = _gen(device, generator)
    hi = low if high is None else high
    return torch.randint(int(low), int(hi), _size(size), generator=g,
                         dtype=canonical_dtype(dtype), device=device)


def _choice(a, key=None, size=(), replace=True, p=None, generator=None):
    g = generator if generator is not None else _random.generator(a.device)
    shape = _size(size)
    k = int(_np.prod(shape)) if shape else 1
    n = a.shape[0]
    if p is not None:
        probs = torch.as_tensor(p, device=a.device).to(torch.float32)
        idx = torch.multinomial(probs, k, replacement=replace, generator=g)
    elif replace:
        idx = torch.randint(0, n, (k,), generator=g, device=a.device)
    else:
        idx = torch.randperm(n, generator=g, device=a.device)[:k]
    return a[idx].reshape(shape + tuple(a.shape[1:]))


def _permutation(a, key=None, generator=None):
    g = generator if generator is not None else _random.generator(a.device)
    return a[torch.randperm(a.shape[0], generator=g, device=a.device)]


def _gamma(shape_param=1.0, scale=1.0, key=None, size=(), dtype="float32",
           generator=None, device=None):
    device, g = _gen(device, generator)
    conc = torch.full(_size(size), float(shape_param),
                      dtype=canonical_dtype(dtype), device=device)
    return scale * torch._standard_gamma(conc, generator=g)


def _std_exponential(size, dtype, device, g):
    out = torch.empty(_size(size), dtype=canonical_dtype(dtype),
                      device=device)
    return out.exponential_(1.0, generator=g)


def _exponential(scale=1.0, key=None, size=(), dtype="float32",
                 generator=None, device=None):
    device, g = _gen(device, generator)
    return scale * _std_exponential(size, dtype, device, g)


def _beta(a=1.0, b=1.0, key=None, size=(), dtype="float32", generator=None,
          device=None):
    device, g = _gen(device, generator)
    dt = canonical_dtype(dtype)
    ga = torch._standard_gamma(torch.full(_size(size), float(a), dtype=dt,
                                          device=device), generator=g)
    gb = torch._standard_gamma(torch.full(_size(size), float(b), dtype=dt,
                                          device=device), generator=g)
    return ga / (ga + gb)


def _poisson(lam=1.0, key=None, size=(), dtype="int32", generator=None,
             device=None):
    device, g = _gen(device, generator)
    rate = torch.full(_size(size), float(lam), dtype=torch.float32,
                      device=device)
    return torch.poisson(rate, generator=g).to(canonical_dtype(dtype))


def _bernoulli(p=0.5, key=None, size=(), dtype="float32", generator=None,
               device=None):
    device, g = _gen(device, generator)
    probs = torch.full(_size(size), float(p), dtype=torch.float32,
                       device=device)
    return torch.bernoulli(probs, generator=g).to(canonical_dtype(dtype))


def _pareto(a=1.0, key=None, size=(), dtype="float32", generator=None,
            device=None):
    device, g = _gen(device, generator)
    return torch.exp(_std_exponential(size, dtype, device, g) / a) - 1.0


def _weibull(a=1.0, key=None, size=(), dtype="float32", generator=None,
             device=None):
    device, g = _gen(device, generator)
    return torch.pow(_std_exponential(size, dtype, device, g), 1.0 / a)


def _rayleigh(scale=1.0, key=None, size=(), dtype="float32", generator=None,
              device=None):
    device, g = _gen(device, generator)
    return scale * torch.sqrt(2.0 * _std_exponential(size, dtype, device, g))


def _powerd(a=1.0, key=None, size=(), dtype="float32", generator=None,
            device=None):
    device, g = _gen(device, generator)
    u = torch.empty(_size(size), dtype=canonical_dtype(dtype), device=device)
    return torch.pow(u.uniform_(0.0, 1.0, generator=g), 1.0 / a)


_reg_fixed("_npi_random_uniform", _uniform, differentiable=False)
_reg_fixed("_npi_random_normal", _normal, differentiable=False)
_reg_fixed("_npi_random_randint", _randint, differentiable=False)
_reg_fixed("_npi_random_choice", _choice, differentiable=False)
_reg_fixed("_npi_random_permutation", _permutation, differentiable=False)
_reg_fixed("_npi_random_gamma", _gamma, differentiable=False)
_reg_fixed("_npi_random_exponential", _exponential, differentiable=False)
_reg_fixed("_npi_random_beta", _beta, differentiable=False)
_reg_fixed("_npi_random_poisson", _poisson, differentiable=False)
_reg_fixed("_npi_random_bernoulli", _bernoulli, differentiable=False)


# ----------------------------------------------------------- npi tail ------
for _new, _old in [
        ("_np_all", "_npi_all"), ("_np_any", "_npi_any"),
        ("_np_cumsum", "_npi_cumsum"), ("_np_diag", "_npi_diag"),
        ("_np_diagflat", "_npi_diagflat"),
        ("_np_diagonal", "_npi_diagonal"), ("_np_dot", "_npi_dot"),
        ("_np_moveaxis", "_npi_moveaxis"), ("_np_reshape", "_npi_reshape"),
        ("_np_roll", "_npi_roll"), ("_np_squeeze", "_npi_squeeze"),
        ("_np_trace", "_npi_trace"), ("_np_transpose", "_npi_transpose"),
        ("_npi_bitwise_not", "_npi_invert"),
        ("_npi_normal", "_npi_random_normal"),
        ("_npi_uniform", "_npi_random_uniform"),
        ("_npi_bernoulli", "_npi_random_bernoulli"),
        ("_npi_exponential", "_npi_random_exponential"),
        ("_npi_gamma", "_npi_random_gamma"),
        ("_npi_choice", "_npi_random_choice"),
]:
    _alias(_new, _old)


@register("_npi_multinomial", differentiable=False)
def _npi_multinomial(pvals=None, n=1, key=None, size=(), generator=None,
                     device=None):
    """Counts over the categories of ``pvals`` from ``n`` draws (int32,
    jnp's int64 with 64-bit types off)."""
    probs = torch.as_tensor(pvals).to(torch.float32)
    device, g = _gen(device if device is not None else
                     (probs.device if probs.device.type != "cpu" else None),
                     generator)
    probs = probs.to(device)
    k = probs.shape[-1]
    shape = _size(size)
    rows = int(_np.prod(shape)) if shape else 1
    draws = torch.multinomial(probs.reshape(-1, k).expand(rows, k)
                              if probs.ndim == 1 else probs.reshape(-1, k),
                              int(n), replacement=True, generator=g)
    counts = torch.zeros(draws.shape[0], k, dtype=torch.int32, device=device)
    counts.scatter_add_(1, draws, torch.ones_like(draws, dtype=torch.int32))
    return counts.reshape(shape + (k,)) if shape else counts.reshape(k)


def _around(a, decimals=0, out=None):
    _defaults_only(out=out)
    return _round(a, decimals)


_reg_fixed("_npi_around", _around)
_reg_fixed("_npi_deg2rad", _promoting(torch.deg2rad))
_reg_fixed("_npi_rad2deg", _promoting(torch.rad2deg))
_reg_fixed("_np_copy", lambda x: x.clone())


def _window(fn, M, dtype, device, ctx):
    dev = _device(device, ctx)
    M = int(M)
    if M < 1:
        return torch.zeros((0,), dtype=canonical_dtype(dtype), device=dev)
    if M == 1:
        return torch.ones((1,), dtype=canonical_dtype(dtype), device=dev)
    n = torch.arange(M, dtype=torch.float64, device=dev)
    return fn(n, M).to(canonical_dtype(dtype))


@register("_npi_hanning", differentiable=False)
def _npi_hanning(M=0, dtype="float32", ctx=None, device=None):
    return _window(lambda n, M: 0.5 - 0.5 * torch.cos(
        2.0 * _math.pi * n / (M - 1)), M, dtype, device, ctx)


@register("_npi_hamming", differentiable=False)
def _npi_hamming(M=0, dtype="float32", ctx=None, device=None):
    return _window(lambda n, M: 0.54 - 0.46 * torch.cos(
        2.0 * _math.pi * n / (M - 1)), M, dtype, device, ctx)


@register("_npi_blackman", differentiable=False)
def _npi_blackman(M=0, dtype="float32", ctx=None, device=None):
    return _window(lambda n, M: 0.42 - 0.5 * torch.cos(
        2.0 * _math.pi * n / (M - 1)) + 0.08 * torch.cos(
        4.0 * _math.pi * n / (M - 1)), M, dtype, device, ctx)


@register("_npi_logspace", differentiable=False)
def _npi_logspace(start=0.0, stop=1.0, num=50, endpoint=True, base=10.0,
                  dtype="float32", ctx=None, device=None):
    lin = _npi_linspace(start, stop, num, endpoint, "float32", ctx, device)
    return torch.pow(_scalar_like(lin, float(base)), lin) \
        .to(canonical_dtype(dtype))


@register("_npi_polyval")
def _npi_polyval(p, x):
    """Horner's rule over the coefficients, as ``jnp.polyval``."""
    y = torch.zeros_like(_inexact(x))
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


@register("_npi_ediff1d")
def _npi_ediff1d(data, to_begin=None, to_end=None):
    d = torch.diff(data.reshape(-1))
    parts = []
    if to_begin is not None:
        parts.append(torch.as_tensor(to_begin, dtype=d.dtype,
                                     device=d.device).reshape(-1))
    parts.append(d)
    if to_end is not None:
        parts.append(torch.as_tensor(to_end, dtype=d.dtype,
                                     device=d.device).reshape(-1))
    return torch.cat(parts) if len(parts) > 1 else d


def _host(x):
    return x.detach().cpu().numpy()


def _back(arr, like):
    return torch.as_tensor(_np.ascontiguousarray(arr)).to(like.device)


@register("_npi_delete", host=True, differentiable=False)
def _npi_delete(data, obj=None, start=None, stop=None, step=None, axis=None):
    """numpy's ``delete`` on a host copy (the JAX op's own route)."""
    arr = _host(data)
    if obj is None:
        obj = slice(start, stop, step)
    elif isinstance(obj, torch.Tensor):
        obj = _host(obj).astype(_np.int64)
    else:
        obj = int(obj)
    return _back(_np.delete(arr, obj, axis=axis), data)


@register("_npi_insert_scalar", host=True, differentiable=False)
def _npi_insert_scalar(data, obj=None, val=0.0, axis=None):
    return _back(_np.insert(_host(data), int(obj), val, axis=axis), data)


@register("_npi_insert_slice", host=True, differentiable=False)
def _npi_insert_slice(data, values, start=None, stop=None, step=None,
                      axis=None):
    return _back(_np.insert(_host(data), slice(start, stop, step),
                            _host(values), axis=axis), data)


@register("_npi_insert_tensor", host=True, differentiable=False)
def _npi_insert_tensor(data, obj, values, axis=None):
    return _back(_np.insert(_host(data), _host(obj).astype(_np.int64),
                            _host(values), axis=axis), data)


@register("_npi_diag_indices_from", differentiable=False)
def _npi_diag_indices_from(data):
    i = torch.arange(data.shape[0], dtype=torch.int32, device=data.device)
    return torch.stack([i] * data.ndim)


def _hsplit_n(n_in, kw):
    ios = kw.get("indices_or_sections", 1)
    return int(ios) if not isinstance(ios, (tuple, list)) else len(ios) + 1


@register("_npi_hsplit", num_outputs=_hsplit_n)
def _npi_hsplit(data, indices_or_sections=1):
    return _np_split(data, indices_or_sections, 1 if data.ndim > 1 else 0)


@register("_npi_dsplit", num_outputs=_hsplit_n)
def _npi_dsplit(data, indices_or_sections=1):
    return _np_split(data, indices_or_sections, 2)


@register("_npi_vsplit", num_outputs=_hsplit_n)
def _npi_vsplit(data, indices_or_sections=1):
    return _np_split(data, indices_or_sections, 0)


# creation ops (np_init_op.cc); ``ctx`` is a Context, ``device`` the
# port's runtime argument
@register("_npi_zeros", differentiable=False)
def _npi_zeros(shape=(), dtype="float32", ctx=None, device=None):
    return torch.zeros(_shape_arg(shape), dtype=_dt(dtype),
                       device=_device(device, ctx))


@register("_npi_ones", differentiable=False)
def _npi_ones(shape=(), dtype="float32", ctx=None, device=None):
    return torch.ones(_shape_arg(shape), dtype=_dt(dtype),
                      device=_device(device, ctx))


@register("_npi_full", differentiable=False, aliases=("_npi_full_like",))
def _npi_full(a=None, shape=(), fill_value=0.0, dtype="float32", ctx=None,
              device=None):
    if a is not None:
        return torch.full_like(a, fill_value)
    return torch.full(_shape_arg(shape), fill_value, dtype=_dt(dtype),
                      device=_device(device, ctx))


@register("_npi_arange", differentiable=False)
def _npi_arange(start=0.0, stop=None, step=1.0, dtype="float32", ctx=None,
                device=None):
    if stop is None:
        start, stop = 0.0, start
    return torch.arange(start, stop, step, dtype=_dt(dtype),
                        device=_device(device, ctx))


@register("_npi_linspace", differentiable=False)
def _npi_linspace(start=0.0, stop=1.0, num=50, endpoint=True,
                  dtype="float32", ctx=None, device=None):
    num = int(num)
    dev = _device(device, ctx)
    out = _linspace_t(float(start), float(stop), num, torch.float32, dev,
                      endpoint=bool(endpoint))
    return out.to(_dt(dtype))


@register("_npi_eye", differentiable=False,
          aliases=("_npi_identity", "_eye"))
def _npi_eye(N=1, M=None, k=0, dtype="float32", ctx=None, device=None):  # noqa: N803
    n = int(N)
    m = n if M is None else int(M)
    out = torch.zeros((n, m), dtype=_dt(dtype), device=_device(device, ctx))
    if -n < int(k) < m:
        torch.diagonal(out, offset=int(k)).fill_(1)
    return out


@register("_npi_tensorinv")
def _npi_tensorinv(a, ind=2):
    return torch.linalg.tensorinv(a, ind=int(ind))


@register("_npi_tensorsolve")
def _npi_tensorsolve(a, b, a_axes=None):
    return torch.linalg.tensorsolve(a, b,
                                    dims=tuple(a_axes) if a_axes else None)


@register("_npi_pinv_scalar_rcond")
def _npi_pinv_scalar_rcond(a, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(a, rtol=rcond, hermitian=hermitian)


@register("_npx_nonzero", host=True, differentiable=False)
def _npx_nonzero(data):
    return _i32(torch.nonzero(data))


@register("_npx_constraint_check", differentiable=False)
def _npx_constraint_check(data, msg="constraint violated"):
    """True when every element is true (a 0-d bool, as the JAX op)."""
    return torch.all(data.bool())


@register("_npx_reshape")
def _npx_reshape(data, newshape=(), reverse=False, order="C"):
    """npx.reshape's codes: -1 infers one dim, -2 copies the remaining
    source dims, -3 merges the next two, -4 splits one source dim into
    the next two entries, -5 merges all remaining source dims."""
    src = list(data.shape)
    tgt = []
    cursor = 0
    codes = list(newshape)
    i = 0
    while i < len(codes):
        s = codes[i]
        if s == -2:
            tgt.extend(src[cursor:])
            cursor = len(src)
        elif s == -3:
            tgt.append(src[cursor] * src[cursor + 1])
            cursor += 2
        elif s == -4:
            d1, d2 = codes[i + 1], codes[i + 2]
            whole = src[cursor]
            if d1 == -1:
                d1 = whole // d2
            if d2 == -1:
                d2 = whole // d1
            tgt.extend([int(d1), int(d2)])
            cursor += 1
            i += 2
        elif s == -5:
            prod = 1
            for d in src[cursor:]:
                prod *= d
            tgt.append(prod)
            cursor = len(src)
        elif s == -1:
            tgt.append(-1)
            cursor += 1
        else:
            tgt.append(int(s))
            cursor += 1
        i += 1
    return torch.reshape(data, tuple(tgt))


@register("_npi_share_memory", host=True, differentiable=False)
def _npi_share_memory(a, b):
    """Whether the two tensors' storage ranges overlap (a 0-d bool). The
    JAX op is always False, XLA buffers never aliasing; a torch view
    does alias its base."""
    def span(t):
        lo = t.data_ptr()
        n = 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride())
                    if s > 0) if t.numel() else 0
        return lo, lo + n * t.element_size()

    (a0, a1), (b0, b1) = span(a), span(b)
    return torch.tensor(a0 < b1 and b0 < a1 and a.numel() > 0
                        and b.numel() > 0, device=a.device)


def _int_operand(data):
    return data.to(torch.int64 if data.dtype == torch.int64
                   else torch.int32)


@register("_npi_lcm_scalar", differentiable=False)
def _npi_lcm_scalar(data, scalar=1):
    d = _int_operand(data)
    return torch.lcm(d, _scalar_like(d, int(scalar)))


@register("_npi_bitwise_and_scalar", differentiable=False)
def _npi_bitwise_and_scalar(data, scalar=0):
    return torch.bitwise_and(_int_operand(data), int(scalar))


@register("_npi_bitwise_or_scalar", differentiable=False)
def _npi_bitwise_or_scalar(data, scalar=0):
    return torch.bitwise_or(_int_operand(data), int(scalar))


@register("_npi_bitwise_xor_scalar", differentiable=False)
def _npi_bitwise_xor_scalar(data, scalar=0):
    return torch.bitwise_xor(_int_operand(data), int(scalar))


@register("_npi_where_lscalar")
def _npi_where_lscalar(cond, x, scalar=0.0):
    return torch.where(cond.bool(), x, scalar)


@register("_npi_where_rscalar")
def _npi_where_rscalar(cond, y, scalar=0.0):
    return torch.where(cond.bool(), scalar, y)


@register("_npi_where_scalar2")
def _npi_where_scalar2(cond, lscalar=0.0, rscalar=0.0):
    c = cond.bool()
    dt = torch.float32 if isinstance(lscalar, float) or \
        isinstance(rscalar, float) else torch.int32
    return torch.where(c, _scalar_like(cond, lscalar, dt),
                       _scalar_like(cond, rscalar, dt))


@register("_npi_boolean_mask_assign_scalar")
def _npi_boolean_mask_assign_scalar(data, mask, value=0.0):
    """``data`` with ``value`` where ``mask`` holds: the input's shape,
    no host read (capturable)."""
    return torch.where(mask.bool(), value, data)


@register("_npi_boolean_mask_assign_tensor")
def _npi_boolean_mask_assign_tensor(data, mask, value):
    return torch.where(mask.bool(), value, data)


# the remaining sampler names and tail distributions
_reg_fixed("_npi_pareto", _pareto, differentiable=False)
_reg_fixed("_npi_weibull", _weibull, differentiable=False)
_reg_fixed("_npi_rayleigh", _rayleigh, differentiable=False)
_alias("_npi_normal_n", "_npi_random_normal")
_alias("_npi_uniform_n", "_npi_random_uniform")
_reg_fixed("_npi_powerd", _powerd, differentiable=False)

# the legacy internal names of ravel/unravel/split_v2
_alias("_unravel_index", "unravel_index")
_alias("_ravel_multi_index", "ravel_multi_index")
_alias("_split_v2", "split_v2")
