"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``. An op is a plain function
on ``torch.Tensor`` arguments, ``fn(*tensors, **hyper_parameters)``,
registered under its MXNet name. The ``nd.<op>`` / ``F.<op>`` wrappers
and ``F.invoke(name, ...)`` (``ndarray/__init__.py``) are generated from
this table.
"""
from __future__ import annotations

from typing import Callable, Dict

__all__ = ["register", "get", "list_ops"]

_REGISTRY: Dict[str, Callable] = {}
_ALIASES: Dict[str, tuple] = {}


def register(name: str, aliases=()):
    """Decorator: register ``fn`` as op ``name`` (and its aliases)."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        _ALIASES[name] = tuple(aliases)
        for a in aliases:
            _REGISTRY[a] = fn
        return fn

    return deco


def get(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"operator {name!r} is not registered in the port "
                       f"({len(_ALIASES)} ops available)") from None


def list_ops():
    """Registered op names (without aliases), sorted."""
    return sorted(_ALIASES)


def aliases(name: str) -> tuple:
    return _ALIASES[name]
