"""Attribute scoping: ``AttrScope``.

Counterpart of ``mxnet_tpu/attribute.py`` (:37-86; MXNet 1.x
``python/mxnet/attribute.py``)::

    with mx.AttrScope(ctx_group="stage1", __lr_mult__="0.1"):
        w = mx.sym.var("w")
    w.attr("ctx_group")  # -> "stage1"

Every symbol made inside a scope (a variable, an op node) carries the
scope's attributes; scopes nest (the inner value wins for a key), are
thread-local, and a scope object's own attributes are restored when it
exits, so it can be entered again elsewhere. Values must be strings.

As in the JAX package, a node keeps its operator parameters and its
scope attributes in one dict, so scope attributes are stored under the
dunder form of their key (``ctx_group`` -> ``__ctx_group__``), which the
evaluator never hands to an op; ``Symbol.attr`` falls back to that form.
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "dunder", "is_dunder", "current"]


def dunder(key):
    """The stored form of a scope attribute's key."""
    return key if is_dunder(key) else f"__{key}__"


def is_dunder(key):
    """Whether ``key`` is in the stored form (a user or scope attribute,
    not an operator parameter)."""
    return key.startswith("__") and key.endswith("__")


class AttrScope:
    """The attributes given to every symbol made inside the scope."""

    _tls = threading.local()

    def __init__(self, **kwargs):
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be string")
        self._attr = {dunder(k): v for k, v in kwargs.items()}
        self._saved_attr = None

    def get(self, attr=None):
        """This scope's attributes with ``attr`` (the user's, which win)
        merged over them, all in the stored form."""
        user = {dunder(k): v for k, v in (attr or {}).items()}
        if self._attr:
            return {**self._attr, **user}
        return user

    def __enter__(self):
        stack = getattr(AttrScope._tls, "stack", None)
        if stack is None:
            stack = AttrScope._tls.stack = []
        self._saved_attr = self._attr
        if stack:
            self._attr = {**stack[-1]._attr, **self._attr}
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        AttrScope._tls.stack.pop()
        self._attr = self._saved_attr
        self._saved_attr = None


_DEFAULT = AttrScope()


def current():
    """The innermost active scope (an empty one outside any scope)."""
    stack = getattr(AttrScope._tls, "stack", None)
    return stack[-1] if stack else _DEFAULT
