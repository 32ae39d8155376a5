"""Automatic names of graph nodes.

Counterpart of ``mxnet_tpu/name.py``: ``NameManager`` gives anonymous
symbols unique ``<hint><n>`` names (``fullyconnected0``,
``elemwise_add3``). Scopes are thread-local and nest; each manager owns
its counters, so tracing a block under a fresh ``NameManager()`` gives
the same node names every time, and the same names as the JAX package
under its own fresh manager. Outside any scope a per-thread default
table counts.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "current"]


class NameManager:
    """``get(name, hint)``: ``name`` when the caller gave one, else the
    next ``hint``-based name from this manager's counters."""

    _tls = threading.local()

    def __init__(self):
        self._counters = {}

    def get(self, name, hint):
        if name:
            return name
        idx = self._counters.get(hint, 0)
        self._counters[hint] = idx + 1
        return f"{hint}{idx}"

    def __enter__(self):
        stack = getattr(NameManager._tls, "stack", None)
        if stack is None:
            stack = NameManager._tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        NameManager._tls.stack.pop()


def current():
    """The innermost active manager, else this thread's default one."""
    stack = getattr(NameManager._tls, "stack", None)
    if stack:
        return stack[-1]
    default = getattr(NameManager._tls, "default", None)
    if default is None:
        default = NameManager._tls.default = NameManager()
    return default
