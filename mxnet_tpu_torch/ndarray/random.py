"""``mx.nd.random``: the stateful sampling front end.

Counterpart of ``mxnet_tpu/ndarray/random.py`` over the ops of
``ops/random_ops.py``, with its signatures: ``uniform``, ``normal``,
``randn``, ``gamma``, ``exponential``, ``poisson``,
``negative_binomial``, ``randint`` and ``bernoulli`` draw from
``mx.random``'s generator of ``ctx``'s device (the current context by
default, the card unless a ``with mx.cpu():`` says otherwise);
``multinomial`` and ``shuffle`` from the generator of their data's
device. Repeated calls advance the stream and ``mx.random.seed`` repeats
it.
"""
from __future__ import annotations

from .. import random as _random
from ..context import current_context
from .ndarray import _invoke

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "randint", "multinomial", "shuffle",
           "bernoulli"]


def _draw(op, ctx, out, **params):
    device = (ctx or current_context()).torch_device()
    params["shape"] = (params["shape"],) if isinstance(params["shape"], int) \
        else tuple(params["shape"])
    res = _invoke(op, [], dict(params, device=device,
                               generator=_random.generator(device)))
    if out is None:
        return res
    return res.copyto(out)


def uniform(low=0.0, high=1.0, shape=(1,), dtype="float32", ctx=None,
            out=None):
    """Samples of U[low, high) of ``shape`` on ``ctx``."""
    return _draw("_random_uniform", ctx, out, low=low, high=high,
                 shape=shape, dtype=dtype)


def normal(loc=0.0, scale=1.0, shape=(1,), dtype="float32", ctx=None,
           out=None):
    """Samples of N(loc, scale**2) of ``shape`` on ``ctx``."""
    return _draw("_random_normal", ctx, out, loc=loc, scale=scale,
                 shape=shape, dtype=dtype)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc, scale, shape or (1,), dtype, ctx)


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", ctx=None,
          out=None):
    """Samples of Gamma(shape ``alpha``, scale ``beta``)."""
    return _draw("_random_gamma", ctx, out, alpha=alpha, beta=beta,
                 shape=shape, dtype=dtype)


def exponential(lam=1.0, shape=(1,), dtype="float32", ctx=None, out=None):
    """Samples of the exponential distribution of rate ``lam``."""
    return _draw("_random_exponential", ctx, out, lam=lam, shape=shape,
                 dtype=dtype)


def poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None, out=None):
    """Poisson samples of mean ``lam``."""
    return _draw("_random_poisson", ctx, out, lam=lam, shape=shape,
                 dtype=dtype)


def negative_binomial(k=1, p=1.0, shape=(1,), dtype="float32", ctx=None,
                      out=None):
    """Failures before the ``k``-th success, each of probability ``p``."""
    return _draw("_random_negative_binomial", ctx, out, k=k, p=p,
                 shape=shape, dtype=dtype)


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None):
    """Integers drawn uniformly from ``[low, high)``."""
    return _draw("_random_randint", ctx, out, low=low, high=high,
                 shape=shape, dtype=dtype)


def bernoulli(p=0.5, shape=(1,), dtype="float32", ctx=None, out=None):
    """1 with probability ``p``, else 0."""
    return _draw("_random_bernoulli", ctx, out, p=p, shape=shape,
                 dtype=dtype)


def _on_data(op, data, out, **params):
    res = _invoke(op, [data], dict(params, generator=_random.generator(
        data._data.device)))
    if out is None:
        return res
    if isinstance(res, tuple):
        return tuple(r.copyto(o) for r, o in zip(res, out))
    return res.copyto(out)


def multinomial(data, shape=(), get_prob=False, dtype="int32", out=None):
    """Category indices drawn from each row of ``data`` (probabilities
    over its last axis) on ``data``'s device; with ``get_prob`` also the
    log-probability of each draw."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return _on_data("_sample_multinomial", data, out, shape=shape,
                    get_prob=get_prob, dtype=dtype)


def shuffle(data, out=None):
    """``data`` with its first axis permuted at random."""
    return _on_data("_shuffle", data, out)
