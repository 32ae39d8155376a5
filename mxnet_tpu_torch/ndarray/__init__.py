"""``mx.nd``: the imperative array API, also the ``F`` that blocks'
``hybrid_forward`` receives.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: every registered op is
exposed as a module-level function taking NDArrays positionally and
hyper-parameters by keyword; ``_contrib_*`` ops appear under
``nd.contrib`` without the prefix (``ndarray/contrib.py``, with the
control flow). ``Dropout`` is overridden, as in the
JAX package, to draw from ``mx.random``'s generator in train mode.
``nd.random`` holds the samplers (``uniform``, ``normal``, ``gamma``, ...).
"""
from __future__ import annotations

import sys as _sys

from .. import autograd as _autograd
from .. import ops as _ops  # noqa: F401  (registers every op)
from .. import random as _random
from ..ops import registry as _registry
from .ndarray import (NDArray, _invoke, arange, array, concat, dot, empty,
                      eye, full, invoke, moveaxis, ones, ones_like, split,
                      stack, waitall, zeros, zeros_like)
from . import random, utils
from .utils import load, save

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "eye", "zeros_like", "ones_like", "concat", "stack", "split",
           "moveaxis", "dot", "waitall", "invoke", "contrib", "random",
           "save", "load", "utils"]


def _make_wrapper(op_name, exposed):
    def wrapper(*args, **kwargs):
        inputs = []
        for a in args:
            if a is None:
                continue
            if not isinstance(a, NDArray):
                raise TypeError(f"{exposed}: expected NDArray inputs, got "
                                f"{type(a).__name__}")
            inputs.append(a)
        return _invoke(op_name, inputs, kwargs)

    wrapper.__name__ = wrapper.__qualname__ = exposed
    wrapper.__doc__ = _registry.get(op_name).__doc__
    return wrapper


_mod = _sys.modules[__name__]
for _name in _registry.list_ops():
    if _name.startswith("_contrib_"):
        continue
    for _exposed in (_name,) + _registry.aliases(_name):
        if not hasattr(_mod, _exposed):
            setattr(_mod, _exposed, _make_wrapper(_name, _exposed))

from . import contrib  # noqa: E402  (needs _make_wrapper)


def Dropout(data, p=0.5, mode="training", axes=(), generator=None,
            **kwargs):  # noqa: N802
    """MXNet's imperative Dropout, as the JAX package's override
    (``mxnet_tpu/ndarray/__init__.py:53-68``): it drops in train mode
    (under ``autograd.record()``) or with ``mode="always"``, the keep mask
    drawn from ``mx.random``'s generator of ``data``'s device and shared
    along ``axes``; otherwise, and for ``p <= 0``, it returns a copy.
    ``generator``, a port extension that ``gluon.nn.Dropout`` passes,
    draws the mask from that ``torch.Generator`` instead. Other keywords
    (``cudnn_off``, ``training``) are accepted and ignored, as there."""
    if not (_autograd.is_training() or mode == "always") or p <= 0:
        return NDArray(data._data.clone())
    if generator is None:
        generator = _random.generator(data._data.device)
    return _invoke("Dropout", [data], {"p": p, "axes": tuple(axes),
                                       "training": True,
                                       "generator": generator})
