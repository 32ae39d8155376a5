"""Gluon basic layers the serving and training paths use.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``: Sequential,
HybridSequential, Dense, Dropout, BatchNorm (:167-233), Embedding (:236),
LayerNorm, InstanceNorm (:285), GroupNorm (:309), Flatten (:339), Lambda
(:348), HybridLambda (:366) and the activations (:391-454: Activation,
LeakyReLU, PReLU with its learned ``alpha``, ELU, SELU, Swish, GELU).
Layers manage
parameters and hyper-parameters; compute goes through the registered
ops, so each also traces into a graph (``export``). ``BatchNorm.cast``
keeps gamma, beta and the running statistics in float32 under a cast to
float16 or bfloat16, as the JAX layer does.
"""
from __future__ import annotations

import math

import torch

from ... import autograd, initializer as init_mod
from ... import random as _random
from ...base import HALF_DTYPES, canonical_dtype
from ...cached_op import update_state
from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "Embedding", "LayerNorm", "InstanceNorm",
           "GroupNorm", "Flatten", "Lambda", "HybridLambda", "Activation",
           "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU"]


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
    device; without one, from ``mx.random``'s generator of the input's
    device (the JAX layer draws from ``mx.random``'s key), which
    ``mx.random.seed`` reseeds and every CUDA graph registers, so a
    captured training forward draws anew at each replay. A CUDA
    ``generator`` of the caller's own is not registered: a capture that
    draws from it raises ``CaptureError``."""

    def __init__(self, rate, axes=(), generator=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = axes
        self._generator = generator

    def hybrid_forward(self, F, x):
        if self._rate <= 0 or not autograd.is_training():
            return x
        gen = self._generator if self._generator is not None else \
            _random.generator(x._data.device)
        return F.Dropout(x, p=self._rate, axes=self._axes, training=True,
                         generator=gen)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class BatchNorm(HybridBlock):
    """Batch normalisation over ``axis`` (the channels). In train mode
    (``autograd.is_training()``, without ``use_global_stats``) it
    normalises with the batch's statistics and writes the running ones,
    ``running * momentum + batch * (1 - momentum)`` with the batch's
    biased variance, in place and outside the autograd graph
    (``update_state``: the tensors keep their storage, which a captured
    training step or pair reads and writes); otherwise it normalises with the running statistics. ``scale=False``
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
    floats (truncated to integers). ``sparse_grad`` is accepted and the
    gradient stays dense, as in the JAX package (``ops/tensor.py:184``)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
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


class _ChannelNorm(HybridBlock):
    """gamma and beta of one value per channel of axis 1, deferred to the
    first forward when ``in_channels`` is 0."""

    def __init__(self, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, prefix, params):
        super().__init__(prefix=prefix, params=params)
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)

    def infer_shape(self, x, *args):
        self.gamma.shape = (x.shape[1],)
        self.beta.shape = (x.shape[1],)


class InstanceNorm(_ChannelNorm):
    """Normalise each channel of each sample over its spatial dims.
    ``axis`` is accepted and, as in the JAX layer, the op normalises
    around axis 1."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)
        self._axis = axis

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        return F.invoke("InstanceNorm", x, gamma, beta, eps=self._epsilon)


class GroupNorm(_ChannelNorm):
    """Normalise over ``num_groups`` groups of the channels (axis 1)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, prefix, params)
        self._num_groups = num_groups

    def hybrid_forward(self, F, x, gamma=None, beta=None):
        return F.invoke("GroupNorm", x, gamma, beta,
                        num_groups=self._num_groups, eps=self._epsilon)


class Flatten(HybridBlock):
    """``(N, ...)`` to ``(N, -1)``."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return "Flatten"


class Lambda(Block):
    """A function as a Block: a callable, or the name of an ``mx.nd``
    function (or of a registered op)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as F

            fn = getattr(F, function, None)
            if fn is None:
                def fn(*a, _n=function, **k):
                    return F.invoke(_n, *a, **k)
            self._fn = fn
        else:
            self._fn = function

    def forward(self, *args):
        return self._fn(*args)


class HybridLambda(HybridBlock):
    """A function ``fn(F, *inputs)`` (or the name of an op) as a
    HybridBlock: it traces into a graph under ``export`` like any layer
    (MobileNet's ``clip`` becomes a ``clip`` node)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._fn_name, self._fn = function, None
        else:
            self._fn_name, self._fn = None, function

    def hybrid_forward(self, F, *args):
        if self._fn is not None:
            return self._fn(F, *args)
        fn = getattr(F, self._fn_name, None)
        if fn is None:
            return F.invoke(self._fn_name, *args)
        return fn(*args)


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


class LeakyReLU(HybridBlock):
    """``alpha * x`` below zero."""

    def __init__(self, alpha=0.01, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.invoke("LeakyReLU", x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope ``alpha`` (``in_channels`` values,
    one per channel of axis 1, or one for all)."""

    def __init__(self, alpha_initializer=init_mod.Constant(0.25),
                 in_channels=1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.alpha = self.params.get("alpha", shape=(in_channels,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha=None):
        return F.invoke("LeakyReLU", x, alpha, act_type="prelu")


class ELU(HybridBlock):
    """``alpha * (exp(x) - 1)`` below zero."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.invoke("LeakyReLU", x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU (Klambauer et al. 2017)."""

    def hybrid_forward(self, F, x):
        return F.invoke("LeakyReLU", x, act_type="selu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.invoke("sigmoid", x * self._beta)


class GELU(HybridBlock):
    """Exact (erf) GELU."""

    def hybrid_forward(self, F, x):
        return F.invoke("LeakyReLU", x, act_type="gelu")
