"""Bucketed, asynchronous cross-worker gradient reduction.

Counterpart of ``mxnet_tpu/kvstore/buckets.py``: ``BucketPlan`` (:69) and
``BucketPipeline`` (:143) and ``comm_stats`` (:381, the telemetry
collector's view: reductions dispatched, bytes sent and reductions in
flight; the port times no wait, so it has no overlap ratio), without
the JAX package's watchdog and trace spans.

* **Bucketing.** Pushed gradients (or their 2-bit codes) are staged into
  size-capped buckets (``MXNET_TPU_BUCKET_BYTES``, default 4 MiB of the
  registered dtype; ``0`` keeps the per-key path). The assignment is a
  function of registration order (the ``init`` sequence) alone, so every
  worker builds the same plan and issues the same collectives in the same
  order.
* **Snapshots at push.** A push takes its value when it is made, so a
  later in-place write to the pushed array never reaches the sum (MXNet
  1.x's engine orders such a write after the push's read). Every key has
  one slot in :class:`FlatLayout`'s flat buffers. Uncompressed, each
  gradient is copied into its slot of the value buffer of its dtype; with
  2-bit compression the store's compress kernel writes the codes straight
  into the key's slot of the wire buffer, in stream order, at push.
* **Row-sparse keys.** A key initialised with a row-sparse value is not
  registered, and a row-sparse push never stages: the store sends its
  rows itself (JAX :352-377).
* **Dispatch.** A bucket's one ``all_reduce`` starts, asynchronously and
  in place on its buffer, the moment its last member is staged; buckets
  still staged at a flush dispatch in descending registration order
  (MXNet's ``priority=-index`` contract), whole: a key not pushed this
  round is reduced with them and not applied.
* **Resolution.** A reduction is waited for at ``pull`` of one of its
  keys, at ``barrier``, or before a slot of its bucket is written again
  (a key pushed twice before its pull drains its bucket first, at the
  same point on every worker). The resolved buckets go back to the store
  together, through its ``_apply_resolved``.

``MXNET_TPU_BUCKET_FORCE=1`` runs a one-worker group through the whole
pipeline (the collective is the identity): a test seam.
"""
from __future__ import annotations

import functools
import os
import weakref

import numpy as _np
import torch

from .. import faults as _faults
from ..base import canonical_dtype

__all__ = ["DEFAULT_BUCKET_BYTES", "bucket_bytes", "bucket_force",
           "BucketPlan", "BucketPipeline", "comm_stats"]

DEFAULT_BUCKET_BYTES = 4 << 20
_LIVE = weakref.WeakSet()   # live pipelines, for comm_stats


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
        # a torch dtype's size: numpy has no bfloat16 of its own
        nbytes = nelems * canonical_dtype(dtype).itemsize
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


class FlatLayout:
    """The pipeline's flat device buffers: every key of the plan in
    registration order, each key's slot starting at a multiple of
    ``ALIGN`` elements, so that every slot is 16-byte aligned in every
    buffer. Bucket ``b`` is the contiguous slice ``ranges[b]`` of each
    buffer, padding (at most ``ALIGN - 1`` elements a key) included; the
    padding is zero and never written. Each buffer is made at first use:

    * ``values(dtype)``: the uncompressed path's pushed values, one buffer
      per dtype;
    * ``wire``: the 2-bit path's int8 codes, the bytes the all-reduce
      sends;
    * ``residual``: the 2-bit path's float32 error feedback, zero at
      first.

    ``codes[key]`` is the key's flat wire slot and ``residuals[key]`` its
    residual slot shaped like the key (views, made once); ``residuals``
    holds the keys of float32 buckets, the ones the multi-tensor compress
    takes (the store keeps another dtype's residual in that dtype)."""

    ALIGN = 16

    def __init__(self, plan, device):
        self.plan, self.device = plan, device
        self.offsets, self.ranges = {}, {}
        off = 0
        for b in plan.buckets:
            lo = off
            for k in b["keys"]:
                self.offsets[k] = off
                off += -(-plan.info[k]["nelems"] // self.ALIGN) * self.ALIGN
            self.ranges[b["bid"]] = (lo, off)
        self.size = off
        self.n_keys = len(plan.order)
        self._values = {}

    def slot(self, key, buf, lo=0):
        """``key``'s slot of ``buf`` (a whole flat buffer, or the slice of
        one that starts at element ``lo``), shaped like the key."""
        info = self.plan.info[key]
        o = self.offsets[key] - lo
        return buf[o:o + info["nelems"]].view(info["shape"])

    def values(self, dtype):
        """The uncompressed path's buffer of ``dtype``."""
        buf = self._values.get(dtype)
        if buf is None:
            buf = self._values[dtype] = torch.zeros(
                self.size, dtype=dtype, device=self.device)
        return buf

    @functools.cached_property
    def wire(self):
        return torch.zeros(self.size, dtype=torch.int8, device=self.device)

    @functools.cached_property
    def residual(self):
        return torch.zeros(self.size, dtype=torch.float32, device=self.device)

    @functools.cached_property
    def codes(self):
        return {k: self.slot(k, self.wire).view(-1) for k in self.offsets}

    @functools.cached_property
    def residuals(self):
        return {k: self.slot(k, self.residual) for k in self.offsets
                if self.plan.info[k]["dtype"] == "float32"}

    @property
    def padding(self):
        """Elements of each buffer that are padding, not slots."""
        return self.size - sum(self.plan.info[k]["nelems"]
                               for k in self.offsets)


class BucketPipeline:
    """Staging, dispatch and resolution for one dist kvstore.

    The store provides ``_dispatch_bucket(flat)`` (starts the in-place
    reduction, or under ``dist_async`` with an optimizer the gather into
    a ``(workers, n)`` host buffer, and returns a handle whose ``tensor``
    is what the collective fills and whose ``result()`` waits for it) and
    ``_apply_resolved(entries)``, which takes ``(bid, keys, metas, flat)``
    for each resolved bucket: its reduced slice of the layout's buffer and
    the keys pushed into it this round, in registration order. A key
    staged with a ``meta`` that holds ``"thr"`` has 2-bit codes in the
    wire, any other its value in the value buffer of its bucket's
    dtype."""

    def __init__(self, kv, cap_bytes):
        self._kv = kv
        self.plan = BucketPlan(cap_bytes)
        self.flat = None     # the FlatLayout, built at first use
        self._staged = {}    # bid -> {key: meta}
        self._inflight = {}  # bid -> (keys, metas, handle), dispatch order
        # buckets reduced, the bytes this worker sent, and the payloads
        # copied into the layout's slots (the snapshots of the uncompressed
        # path, and of 2-bit codes made per key)
        self.stats = {"fused": 0, "bytes": 0, "copies": 0}
        _LIVE.add(self)

    def register(self, key, shape, dtype):
        return self.plan.register(key, shape, dtype)

    def wants(self, key):
        """True when ``key`` was registered at ``init``."""
        return key in self.plan.info

    def compressible(self, key):
        """True when the multi-tensor compress takes ``key`` (a float32
        bucket)."""
        return self.plan.info[key]["dtype"] == "float32"

    def layout(self, device):
        """The :class:`FlatLayout`, built at first use on ``device``, and
        built again (after resolving every reduction, with the residuals
        carried over) when keys registered since."""
        old = self.flat
        if old is not None and old.n_keys == len(self.plan.order):
            return old
        if old is not None:
            self.resolve(None)
        self.flat = FlatLayout(self.plan, device)
        if old is not None and "residual" in vars(old):   # the 2-bit path's
            for k, r in old.residuals.items():
                self.flat.residuals[k].copy_(r)
        return self.flat

    # ---------------------------------------------------------- staging ---
    def _pending(self, key):
        """True when ``key``'s slot is staged or being reduced."""
        bid = self.plan.info[key]["bucket"]
        return key in self._staged.get(bid, ()) or bid in self._inflight

    def drain(self, keys):
        """Dispatch and resolve every bucket in which a listed key is
        staged or in flight, so that the key's slot may be written."""
        bids = {self.plan.info[k]["bucket"] for k in keys if self._pending(k)}
        if bids:
            self._resolve_bids(bids)

    def stage_value(self, key, value, meta=None):
        """Copy one key's payload into its slot and stage it (the snapshot
        at push): a value into the value buffer of its bucket's dtype or,
        with the 2-bit path's ``meta``, int8 codes into the wire."""
        lay = self.layout(value.device)
        self.drain((key,))
        if meta is None:
            buf = lay.values(getattr(torch, self.plan.info[key]["dtype"]))
            meta = {"shape": tuple(value.shape), "dtype": value.dtype}
        else:
            buf = lay.wire
        lay.slot(key, buf).view(-1).copy_(value.reshape(-1))
        self.stats["copies"] += 1
        self._stage(key, meta)

    def stage_codes(self, keys, meta):
        """Stage keys whose codes the store's compress has just written
        into their wire slots (after :meth:`drain` of the same keys)."""
        for k in keys:
            self._stage(k, meta)

    def _stage(self, key, meta):
        bid = self.plan.info[key]["bucket"]
        st = self._staged.setdefault(bid, {})
        st[key] = meta
        if len(st) == len(self.plan.buckets[bid]["keys"]):
            self._dispatch(bid)

    def _dispatch(self, bid):
        metas = self._staged.pop(bid, None)
        if metas is None:
            return
        lo, hi = self.flat.ranges[bid]
        if "thr" in next(iter(metas.values())):   # 2-bit codes in the wire
            buf = self.flat.wire[lo:hi]
        else:
            buf = self.flat.values(getattr(
                torch, self.plan.buckets[bid]["dtype"]))[lo:hi]
        keys = [k for k in self.plan.buckets[bid]["keys"] if k in metas]
        handle = self._kv._dispatch_bucket(buf)
        self._inflight[bid] = (keys, metas, handle)
        self.stats["fused"] += 1
        sent = handle.tensor   # the bucket, or a gather's (workers, n)
        self.stats["bytes"] += sent.numel() * sent.element_size()

    # ------------------------------------------------------- resolution ---
    def resolve(self, keys=None):
        """Resolve pending reductions: the buckets of ``keys`` (a list), or
        all of them for None (a flush). Staged buckets dispatch first,
        latest registered first."""
        if keys is None:
            bids = set(self._staged) | set(self._inflight)
        else:
            bids = {self.plan.info[k]["bucket"] for k in keys
                    if self.wants(k)}
        if bids:
            self._resolve_bids(bids)

    def _resolve_bids(self, bids):
        for bid in sorted(self._staged, reverse=True):
            if bid in bids:
                self._dispatch(bid)
        entries = []
        for bid in [b for b in self._inflight if b in bids]:
            keys, metas, handle = self._inflight.pop(bid)
            if _faults.ARMED:
                # a peer that stopped reducing mid-bucket (JAX :282)
                _faults.point("kvstore.sync")
            entries.append((bid, keys, metas, handle.result()))
        if entries:
            self._kv._apply_resolved(entries)


def comm_stats():
    """``{pipelines, fused, bytes, copies, pending}`` summed over the live
    pipelines (the telemetry collector's source)."""
    agg = {"pipelines": 0, "fused": 0, "bytes": 0, "copies": 0,
           "pending": 0}
    for p in list(_LIVE):
        agg["pipelines"] += 1
        for k in ("fused", "bytes", "copies"):
            agg[k] += p.stats[k]
        agg["pending"] += len(p._inflight)
    return agg
