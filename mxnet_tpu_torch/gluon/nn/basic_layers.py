"""Gluon basic layers the serving and training paths use.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: Sequential,
HybridSequential, Dense, Dropout, BatchNorm (:167-233), Embedding (:236),
LayerNorm, Flatten (:339) and Activation (:391). Layers manage
parameters and hyper-parameters; compute goes through the registered
ops, so each also traces into a graph (``export``). ``BatchNorm.cast``
keeps gamma, beta and the running statistics in float32 under a cast to
float16 or bfloat16, as the JAX layer does.
"""
from __future__ import annotations

import math

import torch

from ... import autograd, initializer as init_mod
from ...base import HALF_DTYPES, canonical_dtype
from ...cached_op import update_state
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "Embedding", "LayerNorm", "Flatten", "Activation"]


class Sequential(Block):
    """Blocks run one after another."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)
        return self

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        return list(self._children.values())[key]

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(HybridBlock):
    """Sequential whose children are hybridizable."""

    add = Sequential.add
    forward = Sequential.forward
    __len__ = Sequential.__len__
    __getitem__ = Sequential.__getitem__
    __iter__ = Sequential.__iter__


class Dense(HybridBlock):
    """Fully-connected layer; weight shape ``(units, in_units)``,
    ``in_units=0`` defers it to the first forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=init_mod.create(bias_initializer),
                    allow_deferred_init=True)
            else:
                self.bias = None

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)

    def hybrid_forward(self, F, x, weight=None, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, num_hidden=self._units,
                                   no_bias=True, flatten=self._flatten)
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        return (f"Dense({self.weight.shape[1] or None} -> {self._units}, "
                f"{self._act_type or 'linear'})")


class Dropout(HybridBlock):
    """Active only in train mode (``autograd.is_training()``). Its keep
    masks come from ``generator``, a ``torch.Generator`` on the input's
    device; without one, a randomly seeded generator is made at the
    first training call."""

    def __init__(self, rate, axes=(), generator=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes
        self._generator = generator

    def hybrid_forward(self, F, x):
        if self._rate <= 0 or not autograd.is_training():
            return x
        if self._generator is None:
            self._generator = torch.Generator(device=x._data.device)
            self._generator.seed()
        return F.Dropout(x, p=self._rate, axes=self._axes, training=True,
                         generator=self._generator)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalisation over ``axis`` (the channels). In train mode
    (``autograd.is_training()``, without ``use_global_stats``) it
    normalises with the batch's statistics and writes the running ones,
    ``running * momentum + batch * (1 - momentum)`` with the batch's
    biased variance, outside the autograd graph (``update_state``);
    otherwise it normalises with the running statistics. ``scale=False``
    fixes gamma at one (``fix_gamma``)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,), grad_req="null",
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,), grad_req="null",
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (channels,)

    def cast(self, dtype):
        """gamma, beta and the running statistics stay float32 when the
        network is cast to float16 or bfloat16 (JAX :207-210)."""
        if canonical_dtype(dtype) in HALF_DTYPES:
            dtype = torch.float32
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma=None, beta=None, running_mean=None,
                       running_var=None):
        training = autograd.is_training() and not self._use_global_stats
        out, mean, var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._epsilon,
            momentum=self._momentum, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=training)
        if training:
            m = self._momentum
            update_state(running_mean,
                         running_mean * m + mean.astype(running_mean.dtype)
                         * (1 - m))
            update_state(running_var,
                         running_var * m + var.astype(running_var.dtype)
                         * (1 - m))
        return out

    def __repr__(self):
        return (f"BatchNorm(axis={self._axis}, eps={self._epsilon}, "
                f"momentum={self._momentum}, in_channels="
                f"{self.gamma.shape[0] if self.gamma.shape else None})")


class Embedding(HybridBlock):
    """Row lookup in a ``(input_dim, output_dim)`` table; ids may be
    floats (truncated to integers)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer)

    def hybrid_forward(self, F, x, weight=None):
        return F.invoke("Embedding", x, weight, input_dim=self._input_dim,
                        output_dim=self._output_dim)

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class LayerNorm(HybridBlock):
    """Layer normalisation over ``axis`` (biased variance)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)

    def infer_shape(self, x, *args):
        channels = x.shape[self._axis]
        self.gamma.shape = (channels,)
        self.beta.shape = (channels,)

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class Flatten(HybridBlock):
    """``(N, ...)`` to ``(N, -1)``."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class Activation(HybridBlock):
    """An elementwise activation (``relu``, ``sigmoid``, ``tanh``,
    ``softrelu``, ``softsign``) as a layer."""

    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation  # before super(): _alias() needs it
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"
