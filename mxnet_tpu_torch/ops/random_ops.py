"""Random sampling ops.

Counterpart of ``mxnet_tpu/ops/random_ops.py``: ``_random_uniform`` and
``_random_normal`` (aliases ``uniform``, ``normal``), ``_random_gamma``,
``_random_exponential``, ``_random_poisson``,
``_random_negative_binomial``, ``_random_randint``,
``_sample_multinomial``, ``_shuffle`` and ``_random_bernoulli``. The JAX
ops take a PRNG key as their first array argument; these take the
``torch.Generator`` to draw from (``generator``) and the device to draw
on (``device``), by default ``mx.random``'s generator of the current
context's device (of the data's device for ``_sample_multinomial`` and
``_shuffle``). Threefry and Philox never agree by value: under one
``mx.random.seed`` the port repeats its own draws, not the JAX
package's. Each sampler draws through a torch sampler that takes the
generator (``uniform_``, ``randn``, ``_standard_gamma``,
``exponential_``, ``poisson``, ``randint``, ``multinomial``,
``randperm``, ``bernoulli_``), so on a card a CUDA graph that registers
the generator draws anew at each replay.

MXNet's parameterisations, as the JAX ops keep them: gamma by shape
``alpha`` and scale ``beta``; exponential by the rate ``lam``; the
negative binomial by ``k`` failures and success probability ``p``, drawn
as a Poisson of a Gamma(k, (1 - p) / p); multinomial over the last axis
of ``data``, whose rows are unnormalised probabilities, with replacement.
``get_prob=True`` also returns the log-probability of each draw, as
MXNet 1.x does (the JAX op ignores the flag and returns the draws
alone).
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import canonical_dtype
from ..context import current_context
from .registry import register


def _target(device, generator):
    device = torch.device(device) if device is not None else \
        current_context().torch_device()
    return device, generator if generator is not None else \
        _random.generator(device)


@register("_random_uniform", aliases=("uniform",))
def _uniform(low=0.0, high=1.0, shape=(), dtype="float32", generator=None,
             device=None):
    """Draws from U[low, high)."""
    device, generator = _target(device, generator)
    out = torch.empty(tuple(shape), dtype=canonical_dtype(dtype),
                      device=device)
    return out.uniform_(low, high, generator=generator)


@register("_random_normal", aliases=("normal",))
def _normal(loc=0.0, scale=1.0, shape=(), dtype="float32", generator=None,
            device=None):
    """``loc + scale * N(0, 1)``, as the JAX op forms it."""
    device, generator = _target(device, generator)
    draws = torch.randn(tuple(shape), dtype=canonical_dtype(dtype),
                        device=device, generator=generator)
    return loc + scale * draws


def _data_target(data, generator):
    return generator if generator is not None else \
        _random.generator(data.device)


@register("_random_gamma")
def _gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", generator=None,
           device=None):
    """``beta * Gamma(alpha, 1)``: shape ``alpha``, scale ``beta``."""
    device, generator = _target(device, generator)
    conc = torch.full(tuple(shape), float(alpha),
                      dtype=canonical_dtype(dtype), device=device)
    return beta * torch._standard_gamma(conc, generator=generator)


@register("_random_exponential")
def _exponential(lam=1.0, shape=(), dtype="float32", generator=None,
                 device=None):
    """Draws of the exponential distribution of rate ``lam``."""
    device, generator = _target(device, generator)
    out = torch.empty(tuple(shape), dtype=canonical_dtype(dtype),
                      device=device)
    return out.exponential_(lam, generator=generator)


@register("_random_poisson")
def _poisson(lam=1.0, shape=(), dtype="float32", generator=None,
             device=None):
    """Poisson draws of mean ``lam``, in ``dtype``."""
    device, generator = _target(device, generator)
    rate = torch.full(tuple(shape), float(lam), dtype=torch.float32,
                      device=device)
    return torch.poisson(rate, generator=generator).to(canonical_dtype(dtype))


@register("_random_negative_binomial")
def _neg_binomial(k=1, p=1.0, shape=(), dtype="float32", generator=None,
                  device=None):
    """Failures before the ``k``-th success of probability ``p``: a
    Poisson draw whose mean is ``Gamma(k, 1) * (1 - p) / p``."""
    device, generator = _target(device, generator)
    conc = torch.full(tuple(shape), float(k), dtype=torch.float32,
                      device=device)
    lam = torch._standard_gamma(conc, generator=generator) * ((1 - p) / p)
    return torch.poisson(lam, generator=generator).to(canonical_dtype(dtype))


@register("_random_randint")
def _randint(low=0, high=1, shape=(), dtype="int32", generator=None,
             device=None):
    """Integers drawn uniformly from ``[low, high)``."""
    device, generator = _target(device, generator)
    return torch.randint(int(low), int(high), tuple(shape),
                         generator=generator, dtype=canonical_dtype(dtype),
                         device=device)


def _multinomial_outputs(n_inputs, kwargs):
    return 2 if kwargs.get("get_prob", False) else 1


@register("_sample_multinomial", num_outputs=_multinomial_outputs)
def _multinomial(data, shape=(), get_prob=False, dtype="int32",
                 generator=None):
    """Category indices drawn from each row of ``data`` (unnormalised
    probabilities over the last axis), ``shape`` draws a row, with
    replacement: of shape ``shape`` for a vector, ``(rows,) + shape``
    for a matrix. With ``get_prob`` also the log-probability of each
    draw (its row normalised)."""
    generator = _data_target(data, generator)
    n = 1
    for d in tuple(shape):
        n *= int(d)
    rows = data.reshape(-1, data.shape[-1]).float().clamp_min(0)
    draws = torch.multinomial(rows, n, replacement=True, generator=generator)
    lead = () if data.dim() == 1 else (data.shape[0],)
    out_shape = lead + tuple(shape)
    out = draws.reshape(out_shape).to(canonical_dtype(dtype))
    if not get_prob:
        return out
    logp = torch.log(rows / rows.sum(-1, keepdim=True))
    picked = torch.gather(logp, 1, draws).reshape(out_shape)
    return out, picked.to(data.dtype)


@register("_shuffle")
def _shuffle(data, generator=None):
    """``data`` with its first axis permuted at random."""
    generator = _data_target(data, generator)
    perm = torch.randperm(data.shape[0], generator=generator,
                          device=data.device)
    return data.index_select(0, perm)


@register("_random_bernoulli")
def _bernoulli(p=0.5, shape=(), dtype="float32", generator=None,
               device=None):
    """1 with probability ``p``, else 0, in ``dtype``."""
    device, generator = _target(device, generator)
    out = torch.empty(tuple(shape), dtype=canonical_dtype(dtype),
                      device=device)
    return out.bernoulli_(float(p), generator=generator)
