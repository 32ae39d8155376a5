"""Bucketed, asynchronous cross-worker gradient reduction.

Counterpart of ``mxnet_tpu/kvstore/buckets.py``: ``BucketPlan`` (:69) and
``BucketPipeline`` (:143), without the JAX package's watchdog, trace
spans and telemetry views, which wait for their modules.

* **Bucketing.** Pushed gradients (or their 2-bit codes) are flattened
  and staged into size-capped buckets (``MXNET_TPU_BUCKET_BYTES``,
  default 4 MiB of the registered dtype; ``0`` keeps the per-key path).
  The assignment is a function of registration order (the ``init``
  sequence) alone, so every worker builds the same plan and issues the
  same collectives in the same order.
* **Dispatch.** A bucket's one ``all_reduce`` starts, asynchronously,
  the moment its last member is pushed; buckets still staged at a flush
  dispatch in descending registration order (MXNet's ``priority=-index``
  contract).
* **Resolution.** A reduction is waited for at ``pull`` of one of its
  keys, at ``barrier`` or when a key is pushed again before its bucket
  resolved; each key's slice then goes back to the store through the
  store's ``_apply_reduced``.

``MXNET_TPU_BUCKET_FORCE=1`` runs a one-worker group through the whole
pipeline (the collective is the identity): a test seam.
"""
from __future__ import annotations

import os

import numpy as _np
import torch

__all__ = ["DEFAULT_BUCKET_BYTES", "bucket_bytes", "bucket_force",
           "BucketPlan", "BucketPipeline"]

DEFAULT_BUCKET_BYTES = 4 << 20


def bucket_bytes():
    """The bucket cap in bytes (``MXNET_TPU_BUCKET_BYTES``; 0 disables
    bucketing)."""
    raw = os.environ.get("MXNET_TPU_BUCKET_BYTES")
    if not raw:
        return DEFAULT_BUCKET_BYTES
    try:
        return max(0, int(raw))
    except ValueError:
        return DEFAULT_BUCKET_BYTES


def bucket_force():
    """True when ``MXNET_TPU_BUCKET_FORCE=1`` engages the pipeline for a
    one-worker group."""
    return os.environ.get("MXNET_TPU_BUCKET_FORCE") == "1"


class BucketPlan:
    """Deterministic key -> bucket assignment, by registration order.

    A key joins the newest bucket when the dtype matches and the bucket
    stays within the byte cap, else it opens the next bucket (so a
    gradient larger than the cap has a bucket of its own). Earlier
    buckets never change when later keys register."""

    def __init__(self, cap_bytes):
        self.cap = int(cap_bytes)
        self.order = []    # keys, registration order
        self.info = {}     # key -> {shape, dtype, nelems, nbytes, bucket}
        self.buckets = []  # [{bid, keys, nbytes, dtype}]

    def register(self, key, shape, dtype):
        """Add ``key`` (idempotent); returns its bucket id."""
        if key in self.info:
            return self.info[key]["bucket"]
        shape = tuple(int(d) for d in shape)
        nelems = int(_np.prod(shape, dtype=_np.int64))
        dtype = str(dtype)
        nbytes = nelems * _np.dtype(dtype).itemsize
        if self.buckets and self.buckets[-1]["dtype"] == dtype \
                and self.buckets[-1]["nbytes"] + nbytes <= self.cap:
            b = self.buckets[-1]
        else:
            b = {"bid": len(self.buckets), "keys": [], "nbytes": 0,
                 "dtype": dtype}
            self.buckets.append(b)
        b["keys"].append(key)
        b["nbytes"] += nbytes
        self.order.append(key)
        self.info[key] = {"shape": shape, "dtype": dtype, "nelems": nelems,
                          "nbytes": nbytes, "bucket": b["bid"]}
        return b["bid"]


class BucketPipeline:
    """Staging, dispatch and resolution for one dist kvstore.

    The store provides ``_dispatch_bucket(flat)`` (starts the reduction
    and returns a handle whose ``result()`` waits for it and returns the
    reduced flat tensor) and ``_apply_reduced(key, piece, meta)``."""

    def __init__(self, kv, cap_bytes):
        self._kv = kv
        self.plan = BucketPlan(cap_bytes)
        self._staged = {}    # bid -> {"vals": {key: flat}, "meta": {key: meta}}
        self._inflight = []  # [(bid, keys, metas, handle)], dispatch order
        # buckets reduced, and the bytes this worker sent
        self.stats = {"fused": 0, "bytes": 0}

    def register(self, key, shape, dtype):
        return self.plan.register(key, shape, dtype)

    def wants(self, key):
        """True when ``key`` was registered at ``init``."""
        return key in self.plan.info

    def enqueue(self, key, flat, meta):
        """Stage one key's flattened payload; the bucket dispatches when
        its last member arrives. A key pushed again before its bucket
        resolved drains that bucket first (every push is its own round),
        at the same point on every worker."""
        bid = self.plan.info[key]["bucket"]
        st = self._staged.get(bid)
        if st is not None and key in st["vals"]:
            self._dispatch(bid)
            self._resolve_where(lambda b: b == bid)
            st = None
        if st is None:
            st = self._staged[bid] = {"vals": {}, "meta": {}}
        st["vals"][key] = flat
        st["meta"][key] = meta
        if len(st["vals"]) == len(self.plan.buckets[bid]["keys"]):
            self._dispatch(bid)

    def _dispatch(self, bid):
        st = self._staged.pop(bid, None)
        if st is None:
            return
        keys = [k for k in self.plan.buckets[bid]["keys"] if k in st["vals"]]
        # a copy even for one key: the reduction works in place
        fused = torch.cat([st["vals"][k] for k in keys])
        handle = self._kv._dispatch_bucket(fused)
        self._inflight.append((bid, keys, st["meta"], handle))
        self.stats["fused"] += 1
        self.stats["bytes"] += fused.numel() * fused.element_size()

    def resolve(self, key=None):
        """Resolve pending reductions: the bucket of ``key``, or all of
        them for None (a flush). Staged buckets dispatch first, latest
        registered first."""
        if key is not None and not self.wants(key):
            return
        want = None if key is None else self.plan.info[key]["bucket"]
        for bid in sorted(self._staged, reverse=True):
            if want is None or bid == want:
                self._dispatch(bid)
        self._resolve_where(lambda b: want is None or b == want)

    def _resolve_where(self, pred):
        remaining = []
        for entry in self._inflight:
            bid, keys, metas, handle = entry
            if not pred(bid):
                remaining.append(entry)
                continue
            flat = handle.result()
            off = 0
            for k in keys:
                n = self.plan.info[k]["nelems"]
                self._kv._apply_reduced(k, flat[off:off + n], metas[k])
                off += n
        self._inflight = remaining
