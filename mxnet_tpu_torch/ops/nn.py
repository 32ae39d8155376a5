"""Neural-net ops the serving and training paths use.

Counterpart of ``mxnet_tpu/ops/nn.py`` (FullyConnected :29, LayerNorm
:226, softmax :283, log_softmax :294, Activation :377, LeakyReLU :391,
Dropout :424). These were plain
XLA in the JAX package, so here they are plain PyTorch (cuBLAS for the
matrix products). Dropout takes an explicit ``torch.Generator`` where the
JAX op took a PRNG key.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


@register("FullyConnected")
def _fully_connected(data, weight, bias=None, num_hidden=None,
                     no_bias=False, flatten=True):
    """weight is ``(num_hidden, in_units)``, the JAX package's layout."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


@register("LayerNorm")
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5,
                output_mean_var=False):
    """Normalise over ``axis`` with the biased variance."""
    x = data.movedim(axis, -1)
    out = F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)
    return out.movedim(-1, axis)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


@register("Activation")
def _activation(data, act_type="relu"):
    if act_type not in _ACTIVATIONS:
        raise ValueError(f"unknown Activation act_type {act_type!r}; "
                         f"expected one of {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[act_type](data)


@register("LeakyReLU")
def _leaky_relu(data, act_type="leaky", slope=0.25):
    """Only the ``gelu`` mode is ported: exact erf GELU, as the JAX op's
    ``jax.nn.gelu(approximate=False)``."""
    if act_type != "gelu":
        raise MXNetError(f"LeakyReLU act_type {act_type!r} is not ported "
                         "yet (only 'gelu'); see ROADMAP.md")
    return F.gelu(data, approximate="none")


@register("Dropout")
def _dropout(data, p=0.5, training=False, generator=None, axes=()):
    """Identity unless ``training``. When training, the keep mask is
    drawn from ``generator``, a ``torch.Generator`` on ``data``'s device,
    which the caller must pass."""
    if not training or p <= 0:
        return data
    if generator is None:
        raise MXNetError("Dropout in training mode needs a torch.Generator")
    shape = list(data.shape)
    for a in axes or ():
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.rand(shape, generator=generator, device=data.device) < keep
    return torch.where(mask, data / keep, torch.zeros((), dtype=data.dtype,
                                                      device=data.device))


@register("softmax")
def _softmax(data, axis=-1, temperature=None, length=None, use_length=False):
    """Softmax over ``axis``; ``use_length`` masks positions at or past
    ``length`` (per leading index) before normalising."""
    if temperature:
        data = data / temperature
    if use_length and length is not None:
        steps = torch.arange(data.shape[axis], device=data.device)
        mask = steps < length.unsqueeze(-1)
        data = data.masked_fill(~mask, float("-inf"))
    return torch.softmax(data, dim=axis)


@register("log_softmax")
def _log_softmax(data, axis=-1, temperature=None):
    if temperature:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)
