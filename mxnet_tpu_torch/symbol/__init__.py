"""``mx.sym``: the graph-building API, also the ``F`` that
``hybrid_forward`` receives when a block is traced (``export``).

Counterpart of ``mxnet_tpu/symbol/__init__.py`` and ``symbol/contrib.py``:
every registered op is a function that composes a node from Symbol
inputs and keyword attributes; ``_contrib_*`` ops appear under
``sym.contrib`` without the prefix (``symbol/contrib.py``);
``invoke(name, ...)`` composes any op by name.
"""
from __future__ import annotations

import sys as _sys

from .. import ops as _ops  # noqa: F401  (registers every op)
from ..ops import registry as _registry
from .symbol import Group, Symbol, _apply_op, load, load_json, var

__all__ = ["Symbol", "var", "Group", "load", "load_json", "invoke",
           "contrib"]


def invoke(op_name, *inputs, **kwargs):
    """Compose op ``op_name`` (the ``F.invoke`` of traced blocks)."""
    return _apply_op(op_name, [i for i in inputs if i is not None], kwargs)


def _make_wrapper(op_name, exposed):
    def wrapper(*args, **kwargs):
        return _apply_op(op_name, list(args), kwargs)

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
