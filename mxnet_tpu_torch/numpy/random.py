"""mx.np.random (MXNet 1.x ``python/mxnet/numpy/random.py``).

Counterpart of ``mxnet_tpu/numpy/random.py``. Every sampler draws from
``mx.random``'s torch generator of the device it draws on (the current
context's by default, ``ctx=`` otherwise), so ``mx.random.seed`` (or
:func:`seed`) repeats the draws; they differ from the JAX package's
threefry draws by value. On a card each draw is a kernel with no host
read, and a CUDA graph that registers the generator draws anew at each
replay. :func:`shuffle` permutes its argument in place on the device.
"""
from __future__ import annotations

from .. import random as _framework_random
from ..context import current_context
from ..ndarray.ndarray import _invoke
from . import _as_np, ndarray

__all__ = ["seed", "uniform", "normal", "randint", "rand", "randn",
           "choice", "shuffle", "permutation", "gamma", "exponential",
           "beta", "poisson", "multinomial", "bernoulli", "pareto",
           "weibull", "rayleigh"]


def seed(seed_value):
    _framework_random.seed(seed_value)


def _size(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(size)


def _draw(op, ctx, **kwargs):
    kwargs["device"] = (ctx or current_context()).torch_device()
    return _invoke(op, [], kwargs, wrap=ndarray)


def uniform(low=0.0, high=1.0, size=None, dtype="float32", ctx=None):
    return _draw("_npi_random_uniform", ctx, low=low, high=high,
                 size=_size(size), dtype=dtype)


def normal(loc=0.0, scale=1.0, size=None, dtype="float32", ctx=None):
    return _draw("_npi_random_normal", ctx, loc=loc, scale=scale,
                 size=_size(size), dtype=dtype)


def randint(low, high=None, size=None, dtype="int32", ctx=None):
    if high is None:
        low, high = 0, low
    return _draw("_npi_random_randint", ctx, low=low, high=high,
                 size=_size(size), dtype=dtype)


def rand(*size):
    return uniform(size=size or ())


def randn(*size):
    return normal(size=size or ())


def choice(a, size=None, replace=True, p=None, ctx=None):
    if isinstance(a, int):
        from . import arange

        a = arange(a, ctx=ctx)
    a = _as_np(a, ctx=ctx)
    kwargs = {"size": _size(size), "replace": replace}
    if p is not None:
        kwargs["p"] = _as_np(p, ctx=a.context)._data
    return _invoke("_npi_random_choice", [a], kwargs, wrap=ndarray)


def permutation(x, ctx=None):
    if isinstance(x, int):
        from . import arange

        x = arange(x, ctx=ctx)
    return _invoke("_npi_random_permutation", [_as_np(x, ctx=ctx)], {},
                   wrap=ndarray)


def shuffle(x):
    """Permute ``x`` along its first axis, in place: a device gather
    into ``x``'s own tensor (no host round trip)."""
    out = permutation(x)
    x._data.copy_(out._data)


def gamma(shape, scale=1.0, size=None, dtype="float32", ctx=None):
    return _draw("_npi_random_gamma", ctx, shape_param=shape, scale=scale,
                 size=_size(size), dtype=dtype)


def exponential(scale=1.0, size=None, dtype="float32", ctx=None):
    return _draw("_npi_random_exponential", ctx, scale=scale,
                 size=_size(size), dtype=dtype)


def beta(a, b, size=None, dtype="float32", ctx=None):
    return _draw("_npi_random_beta", ctx, a=a, b=b, size=_size(size),
                 dtype=dtype)


def poisson(lam=1.0, size=None, dtype="int32", ctx=None):
    return _draw("_npi_random_poisson", ctx, lam=lam, size=_size(size),
                 dtype=dtype)


def bernoulli(p=0.5, size=None, dtype="float32", ctx=None):
    return _draw("_npi_random_bernoulli", ctx, p=p, size=_size(size),
                 dtype=dtype)


def multinomial(n, pvals, size=None, ctx=None):
    """Counts over the categories from ``n`` draws (int32)."""
    pv = _as_np(pvals, ctx=ctx)
    return _invoke("_npi_multinomial", [],
                   {"pvals": pv._data, "n": int(n), "size": _size(size),
                    "device": pv._data.device}, wrap=ndarray)


def pareto(a=1.0, size=None, ctx=None):
    return _draw("_npi_pareto", ctx, a=float(a), size=_size(size))


def weibull(a=1.0, size=None, ctx=None):
    return _draw("_npi_weibull", ctx, a=float(a), size=_size(size))


def rayleigh(scale=1.0, size=None, ctx=None):
    return _draw("_npi_rayleigh", ctx, scale=float(scale),
                 size=_size(size))
