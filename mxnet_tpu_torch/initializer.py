"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: Zero, One, Constant
(PReLU's slope), Uniform, Normal and Xavier, and ``InitDesc`` (a name with graph attributes, as
``Module.init_params`` passes it), with the same name-suffix dispatch (``*bias``/``*beta`` get
zeros, ``*gamma`` ones, unless the Parameter forces its own initializer)
and the same string aliases. Draws come from an explicit CPU
``torch.Generator`` passed by the caller; the Parameter then moves the
values to its device, so the same generator seed gives the same weights
on the CPU and on the card. (The JAX package draws from its global key
stream, so the two packages' draws differ; tests carry weights across
with :mod:`mxnet_tpu_torch.convert`.)
"""
from __future__ import annotations

import math

import torch

from .base import canonical_dtype

__all__ = ["Initializer", "register", "create", "InitDesc", "Zero", "One",
           "Constant", "Uniform", "Normal", "Xavier"]

_INIT_REGISTRY = {}


def register(klass):
    """Register an initializer class under its lowercased name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs):
    """Resolve an initializer from an instance, class or alias string."""
    if init is None:
        return Uniform()
    if isinstance(init, Initializer):
        return init
    if isinstance(init, type) and issubclass(init, Initializer):
        return init(**kwargs)
    if isinstance(init, str):
        key = init.lower()
        if key not in _INIT_REGISTRY:
            raise ValueError(f"unknown initializer {init!r}; registered: "
                             f"{sorted(_INIT_REGISTRY)}")
        return _INIT_REGISTRY[key](**kwargs)
    raise TypeError(f"cannot create initializer from {init!r}")


class InitDesc(str):
    """A parameter's name, with its graph attributes (``attrs``), as
    ``Module.init_params`` hands it to an initializer."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Base initializer; subclasses implement ``_init_weight``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, shape, dtype, generator):
        """A CPU tensor for parameter ``name``, with name-suffix
        dispatch for biases and norm parameters."""
        name = str(name)
        if name.endswith(("bias", "beta", "moving_mean", "running_mean")):
            return torch.zeros(shape, dtype=canonical_dtype(dtype))
        if name.endswith(("gamma", "moving_var", "running_var")):
            return torch.ones(shape, dtype=canonical_dtype(dtype))
        return self.init_array(name, shape, dtype, generator)

    def init_array(self, name, shape, dtype, generator):
        """This initializer's weight rule, whatever the name."""
        return self._init_weight(name, tuple(shape), generator).to(
            canonical_dtype(dtype))

    def _init_weight(self, name, shape, generator):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


def _uniform(shape, scale, generator):
    return (torch.rand(shape, generator=generator, dtype=torch.float64)
            * (2 * scale) - scale).float()


@register
class Zero(Initializer):
    def _init_weight(self, name, shape, generator):
        return torch.zeros(shape)


_INIT_REGISTRY["zeros"] = Zero


@register
class One(Initializer):
    def _init_weight(self, name, shape, generator):
        return torch.ones(shape)


_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    """Every value ``value``."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, shape, generator):
        return torch.full(shape, float(self.value))


@register
class Uniform(Initializer):
    """U(-scale, scale), default scale 0.07."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, shape, generator):
        return _uniform(shape, self.scale, generator)


@register
class Normal(Initializer):
    """N(0, sigma), default sigma 0.01."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, shape, generator):
        return torch.randn(shape, generator=generator) * self.sigma


@register
class Xavier(Initializer):
    """Xavier/Glorot: scale ``sqrt(magnitude / factor)`` with the fan
    factor ``avg``, ``in`` or ``out``; uniform or gaussian draws."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        if rnd_type not in ("uniform", "gaussian"):
            raise ValueError(f"bad rnd_type {rnd_type}")
        if factor_type not in ("avg", "in", "out"):
            raise ValueError(f"bad factor_type {factor_type}")
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, shape, generator):
        hw_scale = 1.0
        if len(shape) < 2:
            fan_in = fan_out = shape[0] if shape else 1
        else:
            if len(shape) > 2:
                hw_scale = float(math.prod(shape[2:]))
            fan_in = shape[1] * hw_scale
            fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            return _uniform(shape, scale, generator)
        return torch.randn(shape, generator=generator) * scale
