"""KVStore (counterpart of ``mxnet_tpu/kvstore/``), also ``mx.kv``."""
from . import buckets
from .base import KVStoreBase
from .kvstore import KVStore, PeerLostError, create

__all__ = ["KVStore", "KVStoreBase", "PeerLostError", "buckets", "create"]
