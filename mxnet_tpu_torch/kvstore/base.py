"""KVStoreBase: the pluggable store interface.

Counterpart of ``mxnet_tpu/kvstore/base.py`` (MXNet 1.x
``python/mxnet/kvstore/base.py``): the abstract init / push / pull /
pushpull / broadcast surface and ``KVStoreBase.register``, by which
external backends plug in. The registry carries ``local`` / ``device``
(in-process), ``dist_*`` (a worker group over ``torch.distributed``) and
any user backend.
"""
from __future__ import annotations

__all__ = ["KVStoreBase"]


class KVStoreBase:
    """Abstract key-value store."""

    kv_registry = {}

    @staticmethod
    def register(klass):
        """Register a kvstore backend under its lowercased class name."""
        KVStoreBase.kv_registry[klass.__name__.lower()] = klass
        return klass

    OPTIMIZER = "optimizer"

    def is_capable(self, capability):
        raise NotImplementedError

    def init(self, key, value):
        raise NotImplementedError

    def push(self, key, value, priority=0):
        raise NotImplementedError

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    def broadcast(self, key, value, out, priority=0):
        raise NotImplementedError

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    @property
    def type(self):
        return type(self).__name__.lower()
