"""KVStore implementations.

Counterpart of ``mxnet_tpu/kvstore/kvstore.py`` (``KVStore`` :91-300,
``_DistKVStore`` :306-778, ``create`` :781-795), for MXNet 1.x's type
strings:

* ``local``, ``device`` (and ``local_update_cpu``,
  ``local_allreduce_cpu``, ``local_allreduce_device``, ``nccl``): one
  process; a push sums its values, a pull returns that sum, or with an
  optimizer set (``set_optimizer``) the push updates the stored weight;
* ``dist_sync``, ``dist_device_sync``, ``dist_sync_device``: a group of
  worker processes (``base.maybe_init_distributed``: gloo over a TCP
  rendezvous). A push sums over workers with ``torch.distributed``, by
  key or in fused buckets (``buckets.py``); with 2-bit gradient
  compression (``set_gradient_compression``) each worker sends int8
  codes with error feedback (K6) and the summed codes are scaled back
  (K7). On the bucketed path a push call compresses all its float32 keys
  with ONE launch (``twobit_compress_multi``) straight into their slots
  of one flat wire buffer (``buckets.FlatLayout``), and a pull call scales
  the reduced slices of its keys back with one ``twobit_decompress``
  launch per contiguous run of buckets. The per-key path, and a bucketed
  key of another dtype, compress with ``twobit_compress`` per key and
  scale back per key in the key's dtype.

Pull semantics follow MXNet 1.x's ``KVStoreLocal`` and
``KVStoreDistServer`` without an updater: a pull after a push returns
that round's sum (over workers for ``dist_*``). The JAX package's
``_DistKVStore`` returns the stored value plus the pushes instead, so its
stored value accumulates across rounds (ROADMAP.md section C).

Not ported yet: ``dist_async`` (its optimizer-on-store needs an
all-gather, which gloo does not do on CUDA tensors) and row-sparse
arrays (``row_sparse_pull``); both raise :class:`MXNetError`. The JAX
package's collective-schedule checker, watchdog and fault points wait
for their modules. Telemetry: ``OP_COUNTS`` feeds
``mxtpu_kvstore_ops_total``, and a dist store's pull reports the time it
waits for its reductions as the step timeline's ``sync`` phase
(``mxnet_tpu/kvstore/kvstore.py:461-465``).
"""
from __future__ import annotations

import time

import torch

from .. import kernels as _kernels
from .. import optimizer as opt_mod
from ..base import MXNetError, dtype_name, maybe_init_distributed
from ..ndarray import NDArray
from ..telemetry import steps as _tsteps
from . import buckets as _buckets
from .base import KVStoreBase

__all__ = ["KVStore", "create", "OP_COUNTS"]

# operation counts, read by the telemetry collector at scrape time
# (mxtpu_kvstore_ops_total{op=...}): plain int bumps, nil per push
OP_COUNTS = {"init": 0, "push": 0, "pull": 0, "barrier": 0,
             "allreduce": 0, "fused": 0}

_LOCAL_TYPES = ("local", "local_update_cpu", "local_allreduce_cpu", "device",
                "local_allreduce_device", "nccl")
_DIST_TYPES = ("dist_sync", "dist_device_sync", "dist_sync_device", "dist")


def _to_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _raw(v):
    return v._data.detach() if isinstance(v, NDArray) else \
        torch.as_tensor(v)


@KVStoreBase.register
class KVStore(KVStoreBase):
    """In-process store: ``local`` and ``device`` semantics (MXNet 1.x
    ``KVStoreLocal``)."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._pending = {}
        self._updater = None
        self._optimizer = None
        self._compression = {}

    @property
    def type(self):
        return self._type

    def is_capable(self, capability):
        return capability == KVStoreBase.OPTIMIZER

    # ------------------------------------------------------------ core ----
    def init(self, key, value):
        """Store a copy of each value under its key; a key already
        initialized keeps its value."""
        OP_COUNTS["init"] += 1
        keys, values = self._canonical(key, value)
        for k, v in zip(keys, values):
            if k not in self._store:
                self._store[k] = NDArray(_raw(v).clone())

    @staticmethod
    def _sum(vals):
        """The sum of one key's pushed values (the caller's own tensor
        when there is one value)."""
        agg = _raw(vals[0])
        for v in vals[1:]:
            agg = agg + _raw(v)
        return agg

    def push(self, key, value, priority=0):
        """Sum each key's value(s); with an optimizer set, update the
        stored weight with the sum, else keep it for the next pull. A
        push of several distinct keys with an optimizer set updates them
        all in one ``Updater.update_multi`` (one fused launch per
        learning-rate group); each key's result is its single push's."""
        OP_COUNTS["push"] += 1
        keys, values = self._canonical_push(key, value)
        if self._updater is not None and len(keys) > 1 and \
                len(set(keys)) == len(keys):
            self._updater.update_multi(
                [self._key_index(k) for k in keys],
                [NDArray(self._sum(vals)) for vals in values],
                [self._store[k] for k in keys])
            return
        for k, vals in zip(keys, values):
            self._apply(k, self._sum(vals), owned=len(vals) > 1)

    def _apply(self, k, agg, owned):
        """Hand one key's reduced gradient to the updater, or keep it for
        the next pull (a copy unless ``owned``: the caller may overwrite
        its gradient before pulling)."""
        if self._updater is not None:
            self._updater(self._key_index(k), NDArray(agg), self._store[k])
            return
        prev = self._pending.get(k)
        if prev is not None:
            self._pending[k] = prev + agg
        else:
            self._pending[k] = agg if owned else agg.clone()

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's current value into ``out`` (an NDArray or a
        list of them) in place, each target keeping its device and dtype:
        one multi-tensor copy for all the keys."""
        OP_COUNTS["pull"] += 1
        keys, outs = self._canonical(key, out)
        srcs, dsts = [], []
        for k, o in zip(keys, outs):
            src = self._value_for_pull(k)
            for target in _to_list(o):
                if target.shape != src.shape:
                    raise ValueError(f"pull of {k!r}: shape {src.shape} "
                                     f"into {target.shape}")
                srcs.append(src._data)
                dsts.append(target._data)
        with torch.no_grad():
            torch._foreach_copy_(dsts, srcs)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("row_sparse_pull needs the row-sparse NDArray, which "
                         "is not ported to mxnet_tpu_torch yet; see "
                         "ROADMAP.md section A")

    # ------------------------------------------------ optimizer-on-store ---
    def set_optimizer(self, optimizer):
        """Update weights inside the store on push (MXNet's
        optimizer-on-server)."""
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Write the store's optimizer states (and, with
        ``dump_optimizer``, the optimizer) to ``fname``."""
        if self._updater is None:
            raise MXNetError("no optimizer is set on this kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Read optimizer states written by :meth:`save_optimizer_states`
        (a pickle: only files this program wrote)."""
        if self._updater is None:
            raise MXNetError("no optimizer is set on this kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    @staticmethod
    def _key_index(key):
        try:
            return int(key)
        except (TypeError, ValueError):
            return key

    def set_gradient_compression(self, compression_params):
        """``{"type": "2bit", "threshold": t}`` (threshold 0.5 by
        default); a falsy value turns compression off. It applies to
        cross-worker traffic, so a local store records it and sends
        nothing compressed, as in MXNet 1.x."""
        if not compression_params:
            self._compression = {}
            return
        params = dict(compression_params)
        ctype = params.get("type", "2bit")
        if ctype != "2bit":
            raise ValueError(f"unsupported gradient compression {ctype!r}; "
                             "only '2bit' is implemented")
        params.setdefault("threshold", 0.5)
        self._compression = params

    @property
    def gradient_compression(self):
        return dict(self._compression)

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        """Wait for the card's queued work (one process has no peers)."""
        OP_COUNTS["barrier"] += 1
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    # --------------------------------------------------------- plumbing ---
    def _canonical(self, key, value):
        keys = _to_list(key)
        if value is None:
            return keys, [None] * len(keys)
        values = _to_list(value)
        if len(keys) == 1 and len(values) > 1 and \
                not isinstance(values[0], (list, tuple)):
            values = [values]
        if len(keys) != len(values):
            raise ValueError(f"{len(keys)} keys vs {len(values)} values")
        return keys, values

    def _canonical_push(self, key, value):
        keys = _to_list(key)
        values = _to_list(value)
        if len(keys) == 1:
            if isinstance(value, (list, tuple)) and len(values) > 1 and \
                    isinstance(values[0], NDArray):
                return keys, [list(values)]
            return keys, [list(_to_list(values[0]))]
        grouped = [list(_to_list(v)) for v in values]
        if len(keys) != len(grouped):
            raise ValueError(f"{len(keys)} keys vs {len(grouped)} values")
        return keys, grouped

    def _value_for_pull(self, k):
        if k not in self._store:
            raise ValueError(f"key {k!r} has not been initialized")
        pending = self._pending.pop(k, None)
        if pending is not None:
            # MXNet 1.x: the merged push replaces the stored value
            self._store[k]._rebind(pending)
        return self._store[k]


class _Reduction:
    """One all-reduce in flight: ``result()`` waits for it and returns
    the summed tensor."""

    __slots__ = ("tensor", "work")

    def __init__(self, tensor, work):
        self.tensor, self.work = tensor, work

    def result(self):
        if self.work is not None:
            self.work.wait()
        return self.tensor


class _DistKVStore(KVStore):
    """Store shared by a group of worker processes (MXNet 1.x
    ``KVStoreDist`` in sync mode): a push sums each key over the
    workers; a pull returns that sum."""

    def __init__(self, kv_type="dist_sync"):
        super().__init__(kv_type)
        self._rank, self._procs = maybe_init_distributed()
        self._residuals = {}   # 2-bit error feedback, per key
        cap = _buckets.bucket_bytes()
        self._pipeline = _buckets.BucketPipeline(self, cap) if cap > 0 \
            else None

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._procs

    def init(self, key, value):
        super().init(key, value)
        if self._pipeline is not None:
            for k in self._canonical(key, value)[0]:
                stored = self._store[k]
                self._pipeline.register(k, stored.shape,
                                        dtype_name(stored.dtype))

    def _bucketed(self, key):
        return self._pipeline is not None and self._pipeline.wants(key) \
            and (self._procs > 1 or _buckets.bucket_force())

    def push(self, key, value, priority=0):
        """Sum each key over the workers. ``priority`` is accepted for
        MXNet's contract; the bucket pipeline realises it by dispatching
        a bucket as soon as its last key arrives (``gluon.Trainer``
        pushes in backward order). Every value is taken at push: a later
        in-place write to it does not reach the sum."""
        OP_COUNTS["push"] += 1
        keys, values = self._canonical_push(key, value)
        compress = bool(self._compression) and self._procs > 1
        batch = {}   # the float32 2-bit bucketed keys of this call: one launch
        for k, vals in zip(keys, values):
            agg = self._sum(vals)
            if self._bucketed(k):
                if not compress:
                    self._pipeline.stage_value(k, agg)
                elif self._pipeline.compressible(k):
                    if k in batch:   # a key listed twice: two rounds
                        self._push_compressed(batch)
                        batch = {}
                    batch[k] = agg
                else:   # per key; the codes copied into the wire slot
                    codes, meta = self._quantize(k, NDArray(agg))
                    self._pipeline.stage_value(k, codes._data, meta)
                continue
            owned = len(vals) > 1
            if self._procs > 1:
                agg = (self._compressed_cross_host_sum(k, NDArray(agg))
                       if compress else self._cross_host_sum(NDArray(agg))
                       )._data
                owned = True
            self._apply(k, agg, owned)
        if batch:
            self._push_compressed(batch)

    def _push_compressed(self, batch):
        """The 2-bit bucketed push of ``{key: gradient}``: drain the
        buckets whose slots are staged or in flight, compress every
        gradient with one launch into the wire, then stage the keys (a
        bucket dispatches when its last key is staged)."""
        keys = list(batch)
        pipe = self._pipeline
        layout = pipe.layout(next(iter(batch.values())).device)
        if self._residuals.get(keys[0]) is not layout.residuals[keys[0]]:
            self._residuals.update(layout.residuals)
        pipe.drain(keys)
        thr = float(self._compression.get("threshold", 0.5))
        self._compress(keys, [batch[k] for k in keys], thr)
        pipe.stage_codes(keys, {"thr": thr, "dtype": torch.float32})

    def _compress(self, keys, grads, thr):
        """K6 over the listed keys in one launch: each gradient's codes
        into its wire slot, its residual slot updated in place."""
        layout = self._pipeline.flat
        _kernels.dispatch("twobit_compress_multi", grads,
                          [layout.residuals[k] for k in keys],
                          [layout.codes[k] for k in keys], thr)

    # ------------------------------------------------- the collectives ---
    def _dispatch_bucket(self, flat):
        """Start one fused reduction of a bucket, in place (it owns
        ``flat``)."""
        import torch.distributed as dist

        OP_COUNTS["fused"] += 1
        if self._procs == 1:
            return _Reduction(flat, None)
        return _Reduction(flat, dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                                                async_op=True))

    def _cross_host_sum(self, value):
        """The sum of ``value`` (an NDArray) over the workers, blocking."""
        import torch.distributed as dist

        wire = value._data.clone()
        if self._procs > 1:
            OP_COUNTS["allreduce"] += 1
            dist.all_reduce(wire, op=dist.ReduceOp.SUM)
        return NDArray(wire)

    def _quantize(self, key, value):
        """2-bit quantization with error feedback: ``grad + residual``
        to int8 codes in {-1, 0, +1}, the quantization error kept as the
        key's next residual (K6). Returns ``(codes, meta)``; the resolve
        needs the threshold and the dtype."""
        thr = float(self._compression.get("threshold", 0.5))
        raw = value._data
        res = self._residuals.get(key)
        if res is None:
            res = torch.zeros_like(raw)
        codes, new_res = _kernels.dispatch("twobit_compress", raw, res, thr)
        self._residuals[key] = new_res
        return NDArray(codes), {"shape": tuple(raw.shape),
                                "dtype": raw.dtype, "thr": thr}

    def _compressed_cross_host_sum(self, key, value):
        """The per-key compressed reduction: quantize, one all-reduce of
        the codes, scale the summed codes back (K7)."""
        codes, meta = self._quantize(key, value)
        summed = self._cross_host_sum(codes)._data
        return NDArray(_kernels.dispatch("twobit_decompress", summed,
                                         meta["thr"], dtype=meta["dtype"]))

    def _apply_resolved(self, entries):
        """Resolved buckets back into the store, as the per-key path would
        apply them: the float32 2-bit buckets scaled back with one K7
        launch per contiguous run of wire slices of one threshold; the
        others key by key (2-bit codes scaled back in the key's dtype; a
        value copied: the buffer is reused)."""
        layout = self._pipeline.flat
        coded = []
        for bid, keys, metas, flat in entries:
            meta = metas[keys[0]]
            if "thr" in meta and meta["dtype"] == torch.float32:
                coded.append((layout.ranges[bid], meta["thr"], keys))
                continue
            lo = layout.ranges[bid][0]
            for k in keys:
                piece = layout.slot(k, flat, lo)
                if "thr" in meta:
                    agg = _kernels.dispatch("twobit_decompress", piece,
                                            meta["thr"],
                                            dtype=metas[k]["dtype"])
                else:
                    agg = piece.clone()
                self._apply(k, agg, owned=True)
        runs = []   # [lo, hi, thr, [keys]], by wire offset
        for (lo, hi), thr, keys in sorted(coded, key=lambda c: c[0]):
            if runs and runs[-1][1] == lo and runs[-1][2] == thr:
                runs[-1][1] = hi
                runs[-1][3].extend(keys)
            else:
                runs.append([lo, hi, thr, list(keys)])
        for lo, hi, thr, keys in runs:
            out = _kernels.dispatch("twobit_decompress", layout.wire[lo:hi],
                                    thr)
            for k in keys:
                self._apply(k, layout.slot(k, out, lo), owned=True)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Wait for the reductions of the keys first (the step timeline's
        ``sync`` phase), then pull."""
        if self._pipeline is not None:
            t0 = time.perf_counter()
            self._pipeline.resolve(_to_list(key))
            _tsteps.phase("sync", (time.perf_counter() - t0) * 1e3)
        super().pull(key, out=out, priority=priority,
                     ignore_sparse=ignore_sparse)

    def barrier(self):
        """Resolve every reduction in flight, then wait for all
        workers."""
        if self._pipeline is not None:
            self._pipeline.resolve(None)
        if self._procs > 1:
            import torch.distributed as dist

            dist.barrier()
        super().barrier()


def create(name="local"):
    """A store by MXNet type string: ``local``, ``device``, ``nccl``
    (and the other in-process aliases), ``dist_sync``,
    ``dist_device_sync``, ``dist_sync_device``; or a registered
    backend's class name."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    lname = name.lower()
    if lname in _LOCAL_TYPES:
        return KVStore(lname)
    if lname in _DIST_TYPES:
        return _DistKVStore(lname)
    if lname.startswith("dist"):
        raise MXNetError(f"kvstore {name!r} is not ported to mxnet_tpu_torch "
                         "yet (dist_async needs an all-gather of CUDA "
                         "tensors, which gloo does not do); see ROADMAP.md "
                         "section A")
    if lname in KVStoreBase.kv_registry and lname != "kvstore":
        return KVStoreBase.kv_registry[lname]()
    raise ValueError(f"unknown KVStore type {name!r}")

