"""Random sampling ops.

Counterpart of ``mxnet_tpu/ops/random_ops.py:19-27``: ``_random_uniform``
and ``_random_normal`` (aliases ``uniform``, ``normal``). The JAX ops
take a PRNG key as their first array argument; these take the
``torch.Generator`` to draw from (``generator``) and the device to draw
on (``device``), by default ``mx.random``'s generator of the current
context's device. Threefry and Philox never agree by value: under one
``mx.random.seed`` the port repeats its own draws, not the JAX
package's. The other samplers of the JAX module (gamma, exponential,
Poisson, negative binomial, randint, multinomial, shuffle, bernoulli)
are not ported yet (``ndarray/random.py`` raises for them).
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
