"""Gluon Parameter / ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py``: a Parameter holds one
NDArray handle over a ``torch.Tensor``; shape dims of 0 are unknown and
resolved at the first forward (deferred initialization).

A trainable parameter's data is a plain tensor. Under
``autograd.record()`` ``data()`` returns a leaf view of it that requires
grad, so ``backward`` writes the parameter's gradient buffer
(``grad()``) while every other reader sees no autograd state.

``substitute({param: ndarray})`` makes ``param.data()`` return other
values on the calling thread only, for the duration of a ``with``. The
serving layer runs a block on its snapshot of the weights this way
without touching the live parameters other threads may be using.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager

import numpy as _np
import torch

from .. import autograd
from .. import initializer as init_mod
from ..base import MXNetError, canonical_dtype
from ..context import Context, cpu, current_context
from ..ndarray import NDArray

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "substitute"]

_tls = threading.local()


@contextmanager
def substitute(mapping):
    """Within the scope, on this thread, ``p.data()`` returns
    ``mapping[p]`` (an NDArray) for each Parameter ``p`` in mapping."""
    prev = getattr(_tls, "subs", None)
    _tls.subs = mapping
    try:
        yield
    finally:
        _tls.subs = prev


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its deferred shape was known."""


class Parameter:
    """A weight. Shape dims equal to 0 are unknown until the first
    forward."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True):
        self.name = name
        self._data = None            # NDArray
        self._deferred_init = None   # (init, ctx, default_init, generator)
        self._leaf = None            # (data tensor, its gradient leaf)
        self.grad_req = grad_req if differentiable else "null"
        self._differentiable = differentiable
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = canonical_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init

    @property
    def grad_req(self):
        """``"write"``, ``"add"`` or ``"null"``: how ``backward`` treats
        this parameter's gradient buffer."""
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be write, add or null, got "
                             f"{req!r}")
        self._grad_req = req
        if req == "null":
            self._leaf = None
        elif self._leaf is not None:
            self._leaf[1]._mx_grad_req = req

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is not None and not (
                len(self._shape) == len(new_shape)
                and all(s in (0, n) for s, n in zip(self._shape, new_shape))):
            raise ValueError(f"Parameter {self.name!r}: shape {new_shape} is "
                             f"incompatible with {self._shape}")
        self._shape = new_shape

    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   generator=None, force_reinit=False):
        """Make the data now, or record a deferred initialization when
        the shape is not known yet. ``generator`` is a CPU
        ``torch.Generator`` (a fresh randomly seeded one when None)."""
        if self._data is not None and not force_reinit:
            return
        ctx = ctx if ctx is not None else current_context()
        if not isinstance(ctx, Context):
            ctx = ctx[0]
        ctx.torch_device()  # an unusable context fails here, not later
        default_init = default_init or init_mod.Uniform()
        if generator is None:
            generator = torch.Generator()
            generator.seed()
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init, generator)
                return
            raise ValueError(f"Cannot initialize Parameter {self.name!r}: "
                             f"unknown shape {self._shape} and "
                             "allow_deferred_init=False")
        self._finish_init(init, ctx, default_init, generator)

    def _finish_init(self, init, ctx, default_init, generator):
        # the parameter's own initializer wins and applies its weight
        # rule whatever the name; a block-level one is a default that
        # goes through name-suffix dispatch
        if self.init is not None:
            data = init_mod.create(self.init).init_array(
                self.name, self._shape, self.dtype, generator)
        else:
            data = init_mod.create(init or default_init)(
                self.name, self._shape, self.dtype, generator)
        self._data = NDArray(data.to(ctx.torch_device()))
        self._deferred_init = None

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not self._shape_known():
            raise DeferredInitializationError(
                f"Parameter {self.name!r} has unknown shape {self._shape}")
        self._finish_init(*self._deferred_init)

    def data(self, ctx=None) -> NDArray:
        subs = getattr(_tls, "subs", None)
        if subs is not None and self in subs:
            return subs[self]
        if self._data is not None:
            # a data tensor that already requires grad (the caller runs
            # autograd on it directly) is its own leaf
            if self._grad_req != "null" and autograd.is_recording() and \
                    not self._data._data.requires_grad:
                return NDArray(self._grad_leaf())
            return self._data
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"Parameter {self.name!r} has not been initialized yet "
                "because its shape is unknown; run a forward pass first")
        raise RuntimeError(f"Parameter {self.name!r} has not been "
                           "initialized; call initialize() first")

    def _grad_leaf(self):
        """The tensor ``backward`` differentiates: a view of the data
        (same storage, so in-place updates show through) that requires
        grad and owns the gradient buffer. Made at first use and again
        when ``set_data`` replaced the data tensor, keeping the buffer.
        The data tensor itself never carries autograd state."""
        base = self._data._data
        if self._leaf is None or self._leaf[0] is not base:
            leaf = base.detach().requires_grad_(True)
            leaf._mx_grad_req = self._grad_req
            if self._leaf is not None:
                old = self._leaf[1]
                if old.grad is not None and old.grad.shape == leaf.shape \
                        and old.grad.dtype == leaf.dtype:
                    leaf.grad = old.grad
                leaf._mx_fresh_grad = getattr(old, "_mx_fresh_grad", False)
            self._leaf = (base, leaf)
        return self._leaf[1]

    def grad(self, ctx=None) -> NDArray:
        """The gradient buffer ``backward`` writes into (zeros until the
        first backward)."""
        self.data()
        if self._grad_req == "null" or \
                not self._data._data.is_floating_point():
            raise RuntimeError(f"Cannot get gradient array for Parameter "
                               f"{self.name!r} because grad_req='null'")
        return NDArray(self._grad_leaf()).grad

    @property
    def _fresh_grad(self):
        """Whether ``backward`` wrote the gradient since the last
        ``gluon.Trainer`` update (the stale-gradient check)."""
        return self._leaf is not None and \
            getattr(self._leaf[1], "_mx_fresh_grad", False)

    @_fresh_grad.setter
    def _fresh_grad(self, value):
        if self._leaf is not None:
            self._leaf[1]._mx_fresh_grad = bool(value)

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        """Set the gradient buffer to zeros (it stays allocated)."""
        if self._leaf is not None and self._leaf[1].grad is not None:
            self._leaf[1].grad.zero_()

    def set_data(self, data):
        """Overwrite the value, keeping the parameter's device. A
        parameter whose initialization was deferred takes its shape from
        ``data`` and is initialized with it."""
        tensor = data._data if isinstance(data, NDArray) else \
            torch.tensor(_np.asarray(data))
        if self._data is None and self._deferred_init is not None:
            self.shape = tuple(tensor.shape)
            ctx = self._deferred_init[1]
            self._data = NDArray(tensor.detach().to(
                device=ctx.torch_device(), dtype=self.dtype, copy=True))
            self._deferred_init = None
            return
        with autograd.pause():
            cur = self.data()
        if tuple(tensor.shape) != cur.shape:
            raise ValueError(f"Parameter {self.name!r}: set_data shape "
                             f"{tuple(tensor.shape)} != {cur.shape}")
        cur._rebind(tensor.detach().to(device=cur._data.device,
                                       dtype=self.dtype, copy=True))

    def cast(self, dtype):
        """Re-create the data in ``dtype`` (JAX :207-215). A parameter
        not initialized yet is made in ``dtype`` when it is. The gradient
        buffer is made anew, in the new dtype, at the next backward
        unless ``grad_req`` is ``"null"``."""
        self.dtype = canonical_dtype(dtype)
        self._leaf = None
        if self._data is not None:
            self._data._rebind(self._data._data.detach().to(self.dtype))

    def var(self):
        """This parameter as a graph input (``export`` traces blocks with
        these); not differentiable means an auxiliary state."""
        from .. import symbol

        return symbol.var(self.name, shape=self._shape, dtype=self.dtype,
                          is_aux=not self._differentiable)

    def __repr__(self):
        return f"Parameter {self.name} (shape={self._shape}, dtype={self.dtype})"


class ParameterDict:
    """Prefix-scoped ordered dict of Parameters with ``get``
    create-or-retrieve semantics."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __repr__(self):
        body = "\n".join(f"  {p!r}" for p in self._params.values())
        return f"ParameterDict '{self._prefix}' (\n{body}\n)"

    def get(self, name, **kwargs):
        """The Parameter ``prefix + name``, created with ``kwargs`` when
        it does not exist (the shared dict is consulted first)."""
        name = self._prefix + name
        param = self._params.get(name)
        if param is None and self._shared is not None and name in self._shared:
            param = self._params[name] = self._shared[name]
        if param is None:
            param = self._params[name] = Parameter(name, **kwargs)
        elif kwargs.get("shape") is not None:
            shape = tuple(kwargs["shape"])
            if param.shape is not None and len(param.shape) == len(shape):
                # a dim the request leaves unknown (0) keeps the known one,
                # as MXNet 1.x's get merges them (a tied Dense over an
                # Embedding's weight; the JAX get refuses: ROADMAP.md C13)
                shape = tuple(n or s for n, s in zip(shape, param.shape))
            param.shape = shape
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("Cannot update self with other because they "
                                 f"have different Parameters named {k!r}")
            self._params[k] = v

    def zero_grad(self):
        for p in self._params.values():
            p.zero_grad()

    def initialize(self, init=None, ctx=None, generator=None,
                   force_reinit=False):
        for p in self._params.values():
            p.initialize(init=init, ctx=ctx, generator=generator,
                         force_reinit=force_reinit)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Set the parameters from a ``.params`` file (``arg:``/``aux:``
        tags dropped). A parameter not initialized yet takes the saved
        array's shape and dtype (int8 quantized weights), on ``ctx`` or
        the context of its deferred initialization."""
        from ..ndarray import utils as nd_utils

        loaded = {restore_prefix + k.replace("arg:", "").replace("aux:", ""):
                  v for k, v in nd_utils.load(filename, ctx=cpu()).items()}
        if not allow_missing:
            missing = [n for n in self.keys() if n not in loaded]
            if missing:
                raise MXNetError(f"parameters {missing} are missing in file "
                                 f"{filename!r}")
        for name, value in loaded.items():
            p = self._params.get(name)
            if p is None:
                if not ignore_extra:
                    raise MXNetError(f"parameter {name!r} loaded from "
                                     f"{filename!r} is not present in this "
                                     "ParameterDict")
                continue
            if p._data is None:
                p.dtype = value.dtype
                if p._deferred_init is None:
                    p.initialize(ctx=ctx)
            p.set_data(value)
