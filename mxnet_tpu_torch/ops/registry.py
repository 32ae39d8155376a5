"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``. An op is a plain function
on ``torch.Tensor`` arguments, ``fn(*tensors, **hyper_parameters)``,
registered under its MXNet name with its number of outputs. The
``nd.<op>`` / ``F.<op>`` wrappers, ``F.invoke(name, ...)``
(``ndarray/__init__.py``) and the ``mx.sym.<op>`` graph composers
(``symbol/__init__.py``) are generated from this table.
"""
from __future__ import annotations

from typing import Callable, Dict

__all__ = ["register", "get", "canonical", "list_ops", "aliases",
           "num_outputs"]

_REGISTRY: Dict[str, Callable] = {}
_ALIASES: Dict[str, tuple] = {}
_CANONICAL: Dict[str, str] = {}
_NUM_OUTPUTS: Dict[str, int] = {}


def register(name: str, aliases=(), num_outputs=1):
    """Decorator: register ``fn`` as op ``name`` (and its aliases); it
    returns a tuple of ``num_outputs`` tensors when that is above 1."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        _ALIASES[name] = tuple(aliases)
        _NUM_OUTPUTS[name] = int(num_outputs)
        for n in (name,) + tuple(aliases):
            _REGISTRY[n] = fn
            _CANONICAL[n] = name
        return fn

    return deco


def get(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"operator {name!r} is not registered in the port "
                       f"({len(_ALIASES)} ops available)") from None


def canonical(name: str) -> str:
    """The registered name of op ``name`` or of the op it aliases."""
    get(name)
    return _CANONICAL[name]


def list_ops():
    """Registered op names (without aliases), sorted."""
    return sorted(_ALIASES)


def aliases(name: str) -> tuple:
    return _ALIASES[name]


def num_outputs(name: str) -> int:
    return _NUM_OUTPUTS[canonical(name)]
