"""Elementwise, scalar, broadcast and logic ops.

Counterpart of ``mxnet_tpu/ops/math.py``: the unary table (:22-64),
``copy``/``zeros_like``/``ones_like``, ``hard_sigmoid``, ``softplus``,
``degrees``, ``radians`` (:66-84), ``clip``, ``Cast``, ``amp_cast``
(:87-109), the ``elemwise_*`` ops (identical shapes, as ``_samedim``
:113 enforces) and ``broadcast_*`` ops (numpy broadcasting) of one binary
table (:124-148), ``broadcast_like``/``_to``/``_axis`` (:150-160) and
the ``_*_scalar`` family (:165-187). ``LeakyReLU`` lives in ``ops/nn.py``.

Each op is one PyTorch expression with the JAX function's semantics:

* comparisons and logical ops return 1/0 in the (promoted) input dtype,
  as MXNet does and as the JAX package's ``_*_scalar`` comparisons do;
  its tensor-tensor comparisons return ``bool``, which MXNet never does;
* ``mod`` is numpy's floor modulo (the sign of the divisor,
  ``jnp.mod``), not ``torch.fmod``; ``round`` and ``rint`` round half to
  even, as ``jnp.round`` does;
* ``maximum``/``minimum`` (and ``clip``, ``hard_sigmoid``, the scalar
  variants, which JAX writes with them) split the gradient evenly at a
  tie, as JAX's do;
* ``gamma`` is ``exp(lgamma(x))``, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

from ..base import canonical_dtype
from .registry import register


def _cbrt(x):
    x = x if x.is_floating_point() else x.to(torch.get_default_dtype())
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _as_mask(b, like):
    """A boolean result as 1/0 in ``like``'s dtype."""
    return b.to(like.dtype)


# ---------------------------------------------------------------- unary ----

_UNARY = {
    "negative": torch.neg,
    # lax.abs's gradient is +1 at 0 (torch.abs's is 0)
    "abs": lambda x: torch.where(x >= 0, x, -x),
    "sign": torch.sign,
    "round": torch.round,
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "sigmoid": torch.sigmoid,
    "softsign": torch.nn.functional.softsign,
    "relu": torch.relu,
    "reciprocal": torch.reciprocal,
    "logical_not": lambda x: _as_mask(x == 0, x),
}


def _unary(name, fn):
    def op(x):
        return fn(x)

    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"Elementwise {name} (``jnp``'s semantics)."
    return op


for _name, _fn in _UNARY.items():
    register(_name)(_unary(_name, _fn))


@register("copy", aliases=("identity", "_copy"))
def _copy_op(x):
    return x.clone()


@register("zeros_like")
def _zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def _ones_like(x):
    return torch.ones_like(x)


def _scalar_t(x, s):
    """The scalar ``s`` as a 0-d tensor on ``x``'s device, in the dtype
    ``x op s`` takes (a fill, which a CUDA graph captures)."""
    return torch.full((), s, dtype=torch.result_type(x, s), device=x.device)


def _clip_impl(x, lo, hi):
    # jnp.clip is maximum then minimum: a tie shares the gradient
    if lo is not None:
        x = torch.maximum(x, _scalar_t(x, lo))
    if hi is not None:
        x = torch.minimum(x, _scalar_t(x, hi))
    return x


@register("hard_sigmoid")
def _hard_sigmoid(x, alpha=0.2, beta=0.5):
    return _clip_impl(alpha * x + beta, 0, 1)


@register("softplus")
def _softplus(x):
    # jax.nn.softplus = logaddexp(x, 0); torch's switches to x above 20
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


@register("degrees")
def _degrees(x):
    return x * (180.0 / math.pi)


@register("radians")
def _radians(x):
    return x * (math.pi / 180.0)


@register("clip")
def _clip(x, a_min=None, a_max=None):
    """Clamp every element into [a_min, a_max]; a bound of None is
    open."""
    return _clip_impl(x, a_min, a_max)


@register("Cast", aliases=("cast",))
def _cast(x, dtype="float32"):
    """Cast to ``dtype``; floats to integers round toward zero."""
    return x.to(canonical_dtype(dtype))


@register("amp_cast")
def _amp_cast(x, dtype="bfloat16"):
    """The cast AMP inserts (identity gradient, in the input's dtype)."""
    return x.to(canonical_dtype(dtype))


# --------------------------------------------------------------- binary ----

def _cmp(fn):
    return lambda a, b: fn(a, b).to(torch.result_type(a, b))


def _logical(fn):
    return lambda a, b: fn(a != 0, b != 0).to(torch.result_type(a, b))


_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.true_divide,
    "mod": torch.remainder,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": torch.hypot,
    "equal": _cmp(torch.eq),
    "not_equal": _cmp(torch.ne),
    "greater": _cmp(torch.gt),
    "greater_equal": _cmp(torch.ge),
    "lesser": _cmp(torch.lt),
    "lesser_equal": _cmp(torch.le),
    "logical_and": _logical(torch.logical_and),
    "logical_or": _logical(torch.logical_or),
    "logical_xor": _logical(torch.logical_xor),
    "arctan2": torch.atan2,
}


def _elemwise(name, fn):
    def op(lhs, rhs):
        if lhs.shape != rhs.shape:
            raise ValueError(
                f"elemwise op requires identical shapes, got "
                f"{tuple(lhs.shape)} vs {tuple(rhs.shape)}; use the "
                "broadcast_* variant")
        return fn(lhs, rhs)

    op.__name__ = op.__qualname__ = f"elemwise_{name}"
    op.__doc__ = f"Elementwise {name} of two arrays of one shape."
    return op


def _broadcast(name, fn):
    def op(lhs, rhs):
        return fn(lhs, rhs)

    op.__name__ = op.__qualname__ = f"broadcast_{name}"
    op.__doc__ = f"Elementwise {name} with numpy broadcasting."
    return op


for _name, _fn in _BINARY.items():
    register(f"elemwise_{_name}", aliases=(f"_{_name}",))(
        _elemwise(_name, _fn))
    register(f"broadcast_{_name}")(_broadcast(_name, _fn))


@register("broadcast_like")
def _broadcast_like(x, like):
    return torch.broadcast_to(x, like.shape)


@register("broadcast_to")
def _broadcast_to(x, shape=()):
    return torch.broadcast_to(x, tuple(shape))


@register("broadcast_axis")
def _broadcast_axis(x, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    return torch.broadcast_to(x, tuple(
        size[axis.index(i)] if i in axis else s
        for i, s in enumerate(x.shape)))


# --------------------------------------------------------------- scalar ----

def _scalar_cmp(fn):
    return lambda x, scalar=0.0: _as_mask(fn(x, scalar), x)


_SCALAR = {
    "_plus_scalar": (lambda x, scalar=0.0: x + scalar),
    "_minus_scalar": (lambda x, scalar=0.0: x - scalar),
    "_rminus_scalar": (lambda x, scalar=0.0: scalar - x),
    "_mul_scalar": (lambda x, scalar=1.0: x * scalar),
    "_div_scalar": (lambda x, scalar=1.0: x / scalar),
    "_rdiv_scalar": (lambda x, scalar=1.0: scalar / x),
    "_mod_scalar": (lambda x, scalar=1.0: torch.remainder(x, scalar)),
    "_rmod_scalar": (lambda x, scalar=1.0: torch.remainder(
        _scalar_t(x, scalar), x)),
    "_power_scalar": (lambda x, scalar=1.0: torch.pow(x, scalar)),
    "_rpower_scalar": (lambda x, scalar=1.0: torch.pow(scalar, x)),
    "_maximum_scalar": (lambda x, scalar=0.0: torch.maximum(
        x, _scalar_t(x, scalar))),
    "_minimum_scalar": (lambda x, scalar=0.0: torch.minimum(
        x, _scalar_t(x, scalar))),
    "_equal_scalar": _scalar_cmp(torch.eq),
    "_not_equal_scalar": _scalar_cmp(torch.ne),
    "_greater_scalar": _scalar_cmp(torch.gt),
    "_greater_equal_scalar": _scalar_cmp(torch.ge),
    "_lesser_scalar": _scalar_cmp(torch.lt),
    "_lesser_equal_scalar": _scalar_cmp(torch.le),
}


def _scalar_op(name, fn, default):
    def op(x, scalar=default):
        return fn(x, scalar)

    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"{name}: ``x`` against the Python number ``scalar``."
    return op


for _name, _fn in _SCALAR.items():
    register(_name)(_scalar_op(_name, _fn, _fn.__defaults__[0]))
