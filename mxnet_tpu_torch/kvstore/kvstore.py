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

* ``dist_async``: the same group; with an optimizer on the store, every
  worker's push is an update of its own (MXNet 1.x's asynchronous
  server, JAX :379-469): the pushes are gathered and each worker's
  gradients are applied, rank 0's first, on every worker, so the replicas
  stay bit-identical; one ``Updater.update_multi`` per worker's
  contribution (one K1 launch for SGD-momentum). Without an optimizer it
  sums, as ``dist_sync``. The gather stages each worker's values through
  pinned host memory and all-gathers the host tensors (gloo does not
  all-gather CUDA tensors), by bucket or, unbucketed, over all the keys
  of a push call; 2-bit compression does not apply to it (JAX
  :409-414). For ResNet-50's 25.6 M values on an NVIDIA H100 80GB HBM3
  (700 W) with two workers this took 161-164 ms, against 216-217 ms for
  the other form, an all-reduce of a zero-filled ``(workers, n)`` card
  buffer in which each worker fills its row, which also sends twice the
  bytes (313-325 against 366 on a slower host; ``chip_smoke.py``
  dist_sparse_async).

Row-sparse values (``ndarray/sparse.py``) stay sparse: a push sums them
by row union (``sparse_add``, JAX ``_merge`` :121-129), and with an
optimizer set the sum takes the lazy update (SGD's ``_sparse_update``);
``row_sparse_pull`` reads only the listed rows, into a row-sparse
``out`` (``_update``) or scattered into zeros for a dense one. On a dist
store a row-sparse push never enters a bucket and is never compressed
(JAX :352-377, :427-433): the workers all-gather its rows through host
memory, padded to the largest worker's row count, indices with values;
``dist_sync`` sums them by row union in rank order, ``dist_async`` with
an optimizer applies each worker's rows as its own lazy update. The JAX
package sends the dense view instead (``_cross_host_sum`` :638-691 reads
``value._data``) and so updates every row there; the sums agree.
``sparse_stats`` counts the rows and bytes sent.

Pull semantics follow MXNet 1.x's ``KVStoreLocal`` and
``KVStoreDistServer`` without an updater: a pull after a push returns
that round's sum (over workers for ``dist_*``). The JAX package's
``_DistKVStore`` returns the stored value plus the pushes instead, so its
stored value accumulates across rounds (ROADMAP.md section C).

Lifecycle (JAX :32-89, :135-157, :640-790): every push and pull beats
the watchdog (``kvstore.push``, ``kvstore.pull``), and a dist store's
gloo waits (the per-key all-reduce, the row gathers, the barrier, and
the bucket pipeline's resolve in ``buckets.py``) run under the
``kvstore.sync`` deadline, past which they raise :class:`PeerLostError`
(a ``watchdog.StallError``) naming the operation, the rank and the group
size. The group's own gloo timeout (``base.RENDEZVOUS_TIMEOUT_S``, 300 s,
given to ``init_process_group``) also bounds each collective: a
``kvstore.sync`` deadline under 300 s fires first, and without one a
lost peer surfaces as gloo's ``RuntimeError`` after 300 s. The JAX
package's collective-schedule checker (``analysis.distcheck``) is not
ported. Telemetry: ``OP_COUNTS`` feeds
``mxtpu_kvstore_ops_total``, and a dist store's pull reports the time it
waits for its reductions as the step timeline's ``sync`` phase
(``mxnet_tpu/kvstore/kvstore.py:461-465``).
"""
from __future__ import annotations

import time

import torch

from .. import faults as _faults
from .. import kernels as _kernels
from .. import optimizer as opt_mod
from .. import watchdog as _watchdog
from ..base import MXNetError, dtype_name, maybe_init_distributed
from ..ndarray import NDArray
from ..ndarray.sparse import RowSparseNDArray, sparse_add
from ..telemetry import steps as _tsteps
from . import buckets as _buckets
from .base import KVStoreBase

__all__ = ["KVStore", "create", "OP_COUNTS", "PeerLostError"]

# operation counts, read by the telemetry collector at scrape time
# (mxtpu_kvstore_ops_total{op=...}): plain int bumps, nil per push
OP_COUNTS = {"init": 0, "push": 0, "pull": 0, "barrier": 0,
             "allreduce": 0, "fused": 0}


class PeerLostError(_watchdog.StallError):
    """A dist kvstore's gloo wait (all-reduce, gather, barrier, bucket
    resolve) missed its ``kvstore.sync`` watchdog deadline: a peer is
    presumed dead or wedged.

    A ``watchdog.StallError`` (its ``point``, ``label``, ``elapsed``,
    ``deadline`` and ``bundle``; the bundle is written when this raises)
    with ``op``, ``rank``, ``num_workers`` and ``census`` (the bucket
    pipeline's pending buckets, for a bucket resolve). ``exit_code``
    (76) is the ladder's peer-lost rung."""

    exit_code = 76   # preempt.PEERLOST_EXIT_CODE

    def __init__(self, op, rank, num_workers, stall, census=None):
        super().__init__(stall.point, stall.label, stall.elapsed,
                         stall.deadline, stall.bundle)
        self.op = op
        self.rank = rank
        self.num_workers = num_workers
        self.census = census
        self.args = (
            f"kvstore {op!r}: peer lost: rank {rank}/{num_workers} "
            f"waited {stall.elapsed:.1f}s (deadline {stall.deadline:g}s) "
            "for the group; a peer process is presumed dead or wedged"
            + (f"; crash bundle: {stall.bundle}" if stall.bundle else "")
            + (f"; bucket census: {census}" if census else ""),)


def bounded_wait(kv, op, fn, census=None):
    """``fn()``, a gloo wait of ``kv`` (a dist store), under the
    ``kvstore.sync`` watchdog point; a stall raises
    :class:`PeerLostError` for ``op``."""
    try:
        return _watchdog.sync(
            "kvstore.sync", fn,
            label=f"{op} rank {kv.rank}/{kv.num_workers}")
    except PeerLostError:
        raise
    except _watchdog.StallError as e:
        raise PeerLostError(op, kv.rank, kv.num_workers, e,
                            census=census() if census else None) from e


_LOCAL_TYPES = ("local", "local_update_cpu", "local_allreduce_cpu", "device",
                "local_allreduce_device", "nccl")
_DIST_TYPES = ("dist_sync", "dist_device_sync", "dist_sync_device", "dist",
               "dist_async")


def _to_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _raw(v):
    return v._data.detach() if isinstance(v, NDArray) else \
        torch.as_tensor(v)


def _merge(a, b):
    """``a + b`` of two reduced values (tensors or row-sparse arrays):
    two row-sparse ones by row union, anything else densely."""
    if isinstance(a, RowSparseNDArray) and isinstance(b, RowSparseNDArray):
        return sparse_add(a, b)
    return _raw(a) + _raw(b)


def _wrap(agg):
    return agg if isinstance(agg, NDArray) else NDArray(agg)


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
        """The sum of one key's pushed values: a row-sparse array when they
        all are (their row union), else a tensor (the caller's own when
        there is one value)."""
        if all(isinstance(v, RowSparseNDArray) for v in vals):
            agg = vals[0]
            for v in vals[1:]:
                agg = sparse_add(agg, v)
            return agg
        agg = _raw(vals[0])
        for v in vals[1:]:
            agg = agg + _raw(v)
        return agg

    def push(self, key, value, priority=0):
        """Sum each key's value(s); with an optimizer set, update the
        stored weight with the sum, else keep it for the next pull. A
        push of several distinct keys with an optimizer set updates them
        all in one ``Updater.update_multi`` (one fused launch per
        learning-rate group, row-sparse sums split off to the lazy
        update); each key's result is its single push's."""
        OP_COUNTS["push"] += 1
        _watchdog.beat("kvstore.push")
        if _faults.ARMED:
            _faults.point("kvstore.push")   # a flaky gradient sync
        keys, values = self._canonical_push(key, value)
        if self._updater is not None and len(keys) > 1 and \
                len(set(keys)) == len(keys):
            self._update_keys(keys, [self._sum(vals) for vals in values])
            return
        for k, vals in zip(keys, values):
            self._apply(k, self._sum(vals), owned=len(vals) > 1)

    def _update_keys(self, keys, aggs):
        """The updater over distinct keys: one ``update_multi`` when it
        has one (an ``Updater``) and no key repeats, else key by key."""
        if len(keys) > 1 and len(set(keys)) == len(keys) and \
                hasattr(self._updater, "update_multi"):
            self._updater.update_multi([self._key_index(k) for k in keys],
                                       [_wrap(a) for a in aggs],
                                       [self._store[k] for k in keys])
            return
        for k, agg in zip(keys, aggs):
            self._updater(self._key_index(k), _wrap(agg), self._store[k])

    def _apply(self, k, agg, owned):
        """Hand one key's reduced value (a tensor or a row-sparse array) to
        the updater, or keep it for the next pull (a copy unless
        ``owned``: the caller may overwrite its gradient before
        pulling)."""
        if self._updater is not None:
            self._updater(self._key_index(k), _wrap(agg), self._store[k])
            return
        prev = self._pending.get(k)
        if prev is not None:
            self._pending[k] = _merge(prev, agg)
        elif owned:
            self._pending[k] = agg
        else:
            self._pending[k] = agg.copy() if isinstance(
                agg, RowSparseNDArray) else agg.clone()

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's current value into ``out`` (an NDArray or a
        list of them) in place, each target keeping its device and dtype:
        one multi-tensor copy for all the keys. A row-sparse ``out`` is
        given the dense value (its parts are derived again when read)."""
        OP_COUNTS["pull"] += 1
        _watchdog.beat("kvstore.pull")
        keys, outs = self._canonical(key, out)
        srcs, dsts = [], []
        for k, o in zip(keys, outs):
            src = self._value_for_pull(k)
            for target in _to_list(o):
                if target.shape != src.shape:
                    raise ValueError(f"pull of {k!r}: shape {src.shape} "
                                     f"into {target.shape}")
                if isinstance(target, RowSparseNDArray):
                    target._rebind(src._data.detach().to(
                        device=target.context.torch_device(),
                        dtype=target.dtype, copy=True))
                    continue
                srcs.append(src._data)
                dsts.append(target._data)
        if dsts:
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
        """Pull only the rows ``row_ids`` lists (one index array, or one
        per ``out``): into a row-sparse ``out`` as its new contents
        (``_update``), into a dense one scattered into zeros."""
        if row_ids is None:
            raise ValueError("row_sparse_pull needs row_ids")
        keys, outs = self._canonical(key, out)
        rids = _to_list(row_ids)
        if len(rids) == 1 and len(outs) > 1:
            rids = rids * len(outs)
        OP_COUNTS["pull"] += 1
        for k, o, r in zip(keys, outs, rids):
            src = self._value_for_pull(k)._data
            ridx = _raw(r).to(device=src.device, dtype=torch.int64)
            rows = src.detach().index_select(0, ridx)
            for target in _to_list(o):
                if isinstance(target, RowSparseNDArray):
                    dev = target.context.torch_device()
                    target._update(rows.to(dev), ridx.to(dev))
                    continue
                with torch.no_grad():
                    target._data.zero_()
                    target._data[ridx.to(target._data.device)] = rows.to(
                        device=target._data.device, dtype=target.dtype)

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
            self._store[k]._rebind(_raw(pending))
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


class _Gather:
    """One gather in flight: ``tensor`` is its ``(workers, n)`` host
    buffer; ``result()`` waits for it and returns the buffer on
    ``device``."""

    __slots__ = ("tensor", "work", "device")

    def __init__(self, tensor, work, device):
        self.tensor, self.work, self.device = tensor, work, device

    def result(self):
        if self.work is not None:
            self.work.wait()
        return self.tensor.to(self.device, non_blocking=True)


class _DistKVStore(KVStore):
    """Store shared by a group of worker processes (MXNet 1.x
    ``KVStoreDist``): in sync mode a push sums each key over the workers
    and a pull returns that sum; ``dist_async`` with an optimizer applies
    each worker's push as its own update."""

    def __init__(self, kv_type="dist_sync"):
        super().__init__(kv_type)
        self._rank, self._procs = maybe_init_distributed()
        self._residuals = {}   # 2-bit error feedback, per key
        cap = _buckets.bucket_bytes()
        self._pipeline = _buckets.BucketPipeline(self, cap) if cap > 0 \
            else None
        # row-sparse pushes sent, the rows of each (the largest worker's,
        # which all pad to) and the bytes every worker receives for them
        # (indices and values of all workers); dense gathers of dist_async
        self.sparse_stats = {"pushes": 0, "rows": 0, "bytes": 0}
        self.gather_stats = {"gathers": 0, "bytes": 0}

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._procs

    def init(self, key, value):
        super().init(key, value)
        if self._pipeline is not None:
            for k, v in zip(*self._canonical(key, value)):
                if isinstance(v, RowSparseNDArray):
                    continue   # row-sparse traffic stays off the buckets
                stored = self._store[k]
                self._pipeline.register(k, stored.shape,
                                        dtype_name(stored.dtype))

    def _bucketed(self, key):
        return self._pipeline is not None and self._pipeline.wants(key) \
            and (self._procs > 1 or _buckets.bucket_force())

    def _gathers(self):
        """True when pushes are gathered and each worker's is applied on
        its own: ``dist_async`` with an optimizer on the store."""
        return self._type == "dist_async" and self._updater is not None

    def push(self, key, value, priority=0):
        """Sum each key over the workers, or, under ``dist_async`` with an
        optimizer, gather every worker's push and apply each in rank
        order. ``priority`` is accepted for MXNet's contract; the bucket
        pipeline realises it by dispatching a bucket as soon as its last
        key arrives (``gluon.Trainer`` pushes in backward order). Every
        value is taken at push: a later in-place write to it does not
        reach the sum. Row-sparse values go to the workers at once, off
        the buckets; the unbucketed dense keys of the call follow the
        bucketed ones."""
        OP_COUNTS["push"] += 1
        _watchdog.beat("kvstore.push")
        if _faults.ARMED:
            _faults.point("kvstore.push")   # a flaky gradient sync
        keys, values = self._canonical_push(key, value)
        gather = self._gathers()
        compress = bool(self._compression) and self._procs > 1 and \
            not gather
        batch = {}   # the float32 2-bit bucketed keys of this call: one launch
        plain = []   # (key, sum, owned) of the unbucketed dense keys
        for k, vals in zip(keys, values):
            agg = self._sum(vals)
            if isinstance(agg, RowSparseNDArray):
                self._push_rows(k, agg, owned=len(vals) > 1)
            elif not self._bucketed(k):
                plain.append((k, agg, len(vals) > 1))
            elif not compress:
                self._pipeline.stage_value(k, agg)
            elif self._pipeline.compressible(k):
                if k in batch:   # a key listed twice: two rounds
                    self._push_compressed(batch)
                    batch = {}
                batch[k] = agg
            else:   # per key; the codes copied into the wire slot
                codes, meta = self._quantize(k, NDArray(agg))
                self._pipeline.stage_value(k, codes._data, meta)
        if gather and self._procs > 1 and plain:
            self._push_gathered(plain)
        else:
            for k, agg, owned in plain:
                if self._procs > 1:
                    agg = (self._compressed_cross_host_sum(k, NDArray(agg))
                           if compress
                           else self._cross_host_sum(NDArray(agg)))._data
                    owned = True
                self._apply(k, agg, owned)
        if batch:
            self._push_compressed(batch)

    def _push_rows(self, k, agg, owned):
        """A row-sparse push: its rows gathered from every worker, then
        summed by row union in rank order (or, gathering, each worker's
        rows applied as its own update)."""
        if self._procs > 1:
            parts = self._gather_rows(agg)
            if self._gathers():
                for part in parts:
                    self._updater(self._key_index(k), part, self._store[k])
                return
            agg = parts[0]
            for part in parts[1:]:
                agg = sparse_add(agg, part)
            owned = True
        self._apply(k, agg, owned)

    def _gather_rows(self, rs):
        """Every worker's rows of a row-sparse push, one row-sparse array
        a worker in rank order, on ``rs``'s device: the row counts, then
        the indices and the values padded to the largest count, each an
        ``all_gather`` of host tensors (pinned when ``rs`` is on a
        card)."""
        import torch.distributed as dist

        idx, vals = rs.indices._data, rs.data._data
        dev, pin = vals.device, vals.device.type == "cuda"

        def gather():
            count = torch.tensor([idx.numel()], dtype=torch.int64)
            counts = [torch.zeros_like(count) for _ in range(self._procs)]
            dist.all_gather(counts, count)
            counts = [int(c) for c in counts]
            most = max(counts)
            hidx = torch.zeros(most, dtype=torch.int64, pin_memory=pin)
            hval = torch.zeros((most,) + tuple(vals.shape[1:]),
                               dtype=vals.dtype, pin_memory=pin)
            hidx[:idx.numel()].copy_(idx)
            hval[:idx.numel()].copy_(vals)
            gidx = [torch.empty_like(hidx) for _ in range(self._procs)]
            gval = [torch.empty_like(hval) for _ in range(self._procs)]
            dist.all_gather(gidx, hidx)
            dist.all_gather(gval, hval)
            return counts, most, hidx, hval, gidx, gval

        counts, most, hidx, hval, gidx, gval = bounded_wait(
            self, "gather_rows", gather)
        st = self.sparse_stats
        st["pushes"] += 1
        st["rows"] += most
        st["bytes"] += self._procs * (hidx.numel() * hidx.element_size() +
                                      hval.numel() * hval.element_size())
        return [RowSparseNDArray(gv[:n].to(dev), gi[:n].to(dev), rs.shape)
                for gi, gv, n in zip(gidx, gval, counts)]

    def _gather(self, flat):
        """Start gathering ``flat`` (1-D) from every worker: this worker's
        values copied into a host buffer (pinned when ``flat`` is on a
        card; the copy waits for the values), then an ``all_gather`` of
        host tensors into a ``(workers, n)`` host buffer. Returns the
        handle whose ``result()`` is that buffer on ``flat``'s device."""
        import torch.distributed as dist

        pin = flat.is_cuda
        rows = torch.empty((self._procs, flat.numel()), dtype=flat.dtype,
                           pin_memory=pin)
        self.gather_stats["gathers"] += 1
        self.gather_stats["bytes"] += rows.numel() * rows.element_size()
        if self._procs == 1:
            rows[0].copy_(flat.reshape(-1))
            return _Gather(rows, None, flat.device)
        mine = torch.empty(flat.numel(), dtype=flat.dtype, pin_memory=pin)
        mine.copy_(flat.reshape(-1))
        return _Gather(rows, dist.all_gather(list(rows.unbind(0)), mine,
                                             async_op=True), flat.device)

    def _push_gathered(self, plain):
        """``dist_async``'s unbucketed dense keys of one push call: one
        gather per dtype over all of them, then each worker's gradients,
        rank 0's first, through one ``update_multi``."""
        keys = [k for k, _, _ in plain]
        groups = {}
        for pos, (_, agg, _) in enumerate(plain):
            groups.setdefault(agg.dtype, []).append(pos)
        per_rank = [[None] * len(plain) for _ in range(self._procs)]
        for positions in groups.values():
            parts = [plain[p][1].reshape(-1) for p in positions]
            rows = self._gather(torch.cat(parts)).result()
            for r in range(self._procs):
                for p, piece in zip(positions, rows[r].split(
                        [t.numel() for t in parts])):
                    per_rank[r][p] = piece.view(plain[p][1].shape)
        for grads in per_rank:
            self._update_keys(keys, grads)

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
        ``flat``), or, gathering, the gather of the bucket into a
        ``(workers, n)`` buffer (:meth:`_gather`)."""
        import torch.distributed as dist

        OP_COUNTS["fused"] += 1
        if self._gathers():
            return self._gather(flat)
        if self._procs == 1:
            return _Reduction(flat, None)
        return _Reduction(flat, dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                                                async_op=True))

    def _cross_host_sum(self, value):
        """The sum of ``value`` (an NDArray) over the workers, blocking."""
        import torch.distributed as dist

        wire = value._data.clone()

        def reduce():
            if _faults.ARMED:
                _faults.point("kvstore.sync")   # a peer stopped reducing
            if self._procs > 1:
                OP_COUNTS["allreduce"] += 1
                dist.all_reduce(wire, op=dist.ReduceOp.SUM)

        bounded_wait(self, "cross_host_sum", reduce)
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
        gathered = [e for e in entries if e[3].dim() == 2]
        if gathered:
            self._apply_gathered(layout, gathered)
            entries = [e for e in entries if e[3].dim() == 1]
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

    def _apply_gathered(self, layout, entries):
        """Gathered buckets (``(workers, n)`` each) back into the store:
        each worker's gradients of every key in them, rank 0's first, as
        one ``update_multi``."""
        keys, slots = [], []
        for bid, bkeys, _, flat in entries:
            lo = layout.ranges[bid][0]
            keys.extend(bkeys)
            slots.extend((flat, k, lo) for k in bkeys)
        for r in range(entries[0][3].shape[0]):
            self._update_keys(keys, [layout.slot(k, flat[r], lo)
                                     for flat, k, lo in slots])

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Wait for the reductions of the keys first, then pull the
        rows."""
        if self._pipeline is not None:
            self._pipeline.resolve(_to_list(key))
        super().row_sparse_pull(key, out=out, priority=priority,
                                row_ids=row_ids)

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

        def rendezvous():
            if _faults.ARMED:
                _faults.point("kvstore.sync")   # a peer that died before it
            if self._procs > 1:
                import torch.distributed as dist

                dist.barrier()

        bounded_wait(self, "barrier", rendezvous)
        super().barrier()


def create(name="local"):
    """A store by MXNet type string: ``local``, ``device``, ``nccl``
    (and the other in-process aliases), ``dist_sync``,
    ``dist_device_sync``, ``dist_sync_device``, ``dist_async``; or a
    registered backend's class name."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    lname = name.lower()
    if lname in _LOCAL_TYPES:
        return KVStore(lname)
    if lname in _DIST_TYPES:
        return _DistKVStore(lname)
    if lname in KVStoreBase.kv_registry and lname != "kvstore":
        return KVStoreBase.kv_registry[lname]()
    raise ValueError(f"unknown KVStore type {name!r}")
