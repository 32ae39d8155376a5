"""KVStore (counterpart of ``mxnet_tpu/kvstore/``), also ``mx.kv``."""
from . import buckets
from .base import KVStoreBase
from .kvstore import KVStore, create

__all__ = ["KVStore", "KVStoreBase", "buckets", "create"]
