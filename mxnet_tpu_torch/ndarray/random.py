"""``mx.nd.random``: the stateful sampling front end.

Counterpart of ``mxnet_tpu/ndarray/random.py`` over the ops of
``ops/random_ops.py``: ``uniform``, ``normal`` and ``randn`` draw from
``mx.random``'s generator of ``ctx``'s device (the current context by
default, the card unless a ``with mx.cpu():`` says otherwise), so
repeated calls advance the stream and ``mx.random.seed`` repeats it. The
other samplers raise :class:`MXNetError` (``ROADMAP.md`` section A).
"""
from __future__ import annotations

from .. import random as _random
from ..base import MXNetError
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


def _not_ported(name):
    def sampler(*args, **kwargs):
        raise MXNetError(f"nd.random.{name} is not ported to mxnet_tpu_torch "
                         "yet (only uniform, normal and randn); see "
                         "ROADMAP.md section A")

    sampler.__name__ = sampler.__qualname__ = name
    sampler.__doc__ = "Not ported yet; raises MXNetError."
    return sampler


gamma = _not_ported("gamma")
exponential = _not_ported("exponential")
poisson = _not_ported("poisson")
negative_binomial = _not_ported("negative_binomial")
randint = _not_ported("randint")
multinomial = _not_ported("multinomial")
shuffle = _not_ported("shuffle")
bernoulli = _not_ported("bernoulli")
