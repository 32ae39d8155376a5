"""Content-addressed prediction cache (counterpart of
``mxnet_tpu/serving/cache.py``): a repeated request is answered from
memory instead of a batch slot.

A served model is a pure function of its weights, so an answer is fully
determined by ``(model version, input bytes)``. The cache sits in front
of the batcher (:meth:`BucketBatcher.submit` looks it up before
admission): a hit fulfils the future on the submit thread and never
touches the queue or the card.

Correctness rides on the key::

    key = (model name, model version at lookup, sha1 of dtype/shape/bytes)

byte-identical to the JAX package's for the same array and version, and
on an insert-side guard: an answer is only inserted under the version
that computed it (``ServedModel.run_versioned`` reports the version the
batch read). After a live weight swap the old entries' keys are never
generated again; ``invalidate()`` drops them eagerly for memory, but a
stale entry is unreachable either way.

Bounded LRU (``serving.config`` ``cache_entries``) and thread-safe.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np

__all__ = ["PredictionCache", "content_key"]


def content_key(model, version, arr):
    """The content address of one request row-block: model name x served
    version x input bytes (dtype and shape ride inside the hash so a
    reshaped or recast input never aliases). Returns a small str."""
    h = hashlib.sha1()
    h.update(str(arr.dtype).encode())
    h.update(repr(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return f"{model}@{version}:{h.hexdigest()}"


def _copy(value):
    """Defensive copy of a fulfilment value (one array, or a list of
    arrays for multi-output models) — cached entries must never alias a
    caller's buffer."""
    if isinstance(value, (list, tuple)):
        return [np.array(v, copy=True) for v in value]
    return np.array(value, copy=True)


class PredictionCache:
    """Bounded LRU over content keys for one model's predictions."""

    def __init__(self, capacity=4096):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._data = OrderedDict()       # key -> (np result, version)
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.invalidations = 0
        self._version = None             # last version seen (flip detect)

    # ---------------------------------------------------------- lookup ---
    def get(self, key):
        """The cached prediction for ``key`` (a copy — callers mutate
        results freely) or None. Counts the hit/miss."""
        with self._lock:
            hit = self._data.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return _copy(hit[0])

    def put(self, key, value, version):
        """Insert ``value`` computed by ``version``. The caller passes
        the version that RAN the batch (run_versioned's report) and the
        key it admitted under; a mismatch means the model flipped while
        the request was in flight — the result is still correct for its
        key, but the key names the OLD version so inserting it can never
        serve stale data under the new one. Eldest entries fall off past
        capacity."""
        val = _copy(value)
        with self._lock:
            if self._version is None:
                self._version = version
            elif version != self._version:
                # served version flipped: drop the dead generation now
                self._version = version
                self._invalidate_locked()
            if key in self._data:
                self._data.move_to_end(key)
                self._data[key] = (val, version)
                return
            self._data[key] = (val, version)
            self.insertions += 1
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    # ------------------------------------------------------ invalidate ---
    def _invalidate_locked(self):
        n = len(self._data)
        self._data.clear()
        if n:
            self.invalidations += n

    def invalidate(self, version=None):
        """Drop everything (model-bus version flip / rollout). With a
        ``version`` the new generation is remembered so put() stops
        re-invalidating. Returns how many entries were dropped."""
        with self._lock:
            n = len(self._data)
            self._invalidate_locked()
            if version is not None:
                self._version = version
        return n

    def observe_version(self, version):
        """Cheap flip detector for the submit path: when the served
        version moved since the last call, invalidate. Lookup keys carry
        the version so this is belt-and-braces for memory, not for
        correctness."""
        with self._lock:
            if self._version is None:
                self._version = version
            elif version != self._version:
                self._version = version
                self._invalidate_locked()

    # ----------------------------------------------------------- state ---
    def __len__(self):
        with self._lock:
            return len(self._data)

    def stats(self):
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._data),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "hit_ratio": round(self.hits / total, 4) if total else None,
                "insertions": self.insertions,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "version": self._version,
            }
