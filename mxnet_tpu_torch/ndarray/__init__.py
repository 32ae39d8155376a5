"""``mx.nd``: the imperative array API, also the ``F`` that blocks'
``hybrid_forward`` receives.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: every registered op is
exposed as a module-level function taking NDArrays positionally and
hyper-parameters by keyword; ``_contrib_*`` ops appear under
``nd.contrib`` without the prefix.
"""
from __future__ import annotations

import sys as _sys
import types as _types

from .. import ops as _ops  # noqa: F401  (registers every op)
from ..ops import registry as _registry
from .ndarray import NDArray, _invoke, array, invoke, zeros

__all__ = ["NDArray", "array", "zeros", "invoke", "contrib"]


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
contrib = _types.ModuleType(__name__ + ".contrib",
                            "Contrib ops (``_contrib_<name>`` as ``<name>``).")
for _name in _registry.list_ops():
    if _name.startswith("_contrib_"):
        _short = _name[len("_contrib_"):]
        setattr(contrib, _short, _make_wrapper(_name, _short))
        continue
    for _exposed in (_name,) + _registry.aliases(_name):
        if not hasattr(_mod, _exposed):
            setattr(_mod, _exposed, _make_wrapper(_name, _exposed))
