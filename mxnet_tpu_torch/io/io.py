"""Data iterators.

Counterpart of ``mxnet_tpu/io/io.py``: ``DataDesc`` :255, ``DataBatch``
:268, ``DataIter`` :295, ``NDArrayIter`` :356 with its ``state_dict``
:451, ``ResizeIter`` :474, ``PrefetchingIter`` :523, ``DeviceStager``
:30 (one device), ``MNISTIter`` :806, ``CSVIter`` :831,
``ImageRecordIter`` :927, ``TokenRecordIter`` :1283 and
``write_token_shard`` :1355, with the record readers' deterministic
epochs (``_gang_shard`` :110, ``_ShardedEpochMixin`` :130): the epoch's
order is a function of ``(seed, epoch)`` and each augmentation draw of
``(seed, epoch, position)``, so ``state_dict``/``load_state_dict``
resume a stream mid-epoch bit for bit and ``num_parts``/``part_index``
tile it.

Batches are NDArrays on the current context (the card unless a ``with
mx.cpu():`` says otherwise); ``ImageRecordIter`` and ``PrefetchingIter``
take the context at construction (``ctx=`` / ``device=``).
``LibSVMIter`` (JAX :846) yields CSR batches (``ndarray/sparse.py``).
The fault-injection points are the JAX package's: ``io.fetch`` in each
``PrefetchingIter`` worker (JAX :631), ``io.decode`` at each
``ImageRecordIter`` batch and ``TokenRecordIter`` read (:1117, :1343),
and a JPEG record that the batch decode rejects is decoded again under
``faults.retry`` before it is zero-filled (:1159). Not ported: the
multi-card staging of ``DeviceStager`` (``mesh=``, ``shardings=``).
``PrefetchingIter``'s workers beat ``io.fetch`` as each batch is staged,
and its join on them is bounded by an ``io.fetch`` watchdog deadline
(JAX :618-680): a stall abandons the (daemon) workers and sticks until
``reset()``. ``PrefetchingIter`` and ``ImageRecordIter`` keep
their ``data_wait_ms`` and stage times, and report each wait to the step
timeline as the next step's ``data_wait`` phase
(:mod:`mxnet_tpu_torch.telemetry.steps`, JAX :696-708 and :1254-1266).
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
import time
import warnings
import weakref
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

import numpy as _np
import torch

from .. import faults as _faults
from .. import watchdog as _watchdog
from .. import native
from .. import ndarray as nd
from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray import NDArray
from ..telemetry import steps as _tsteps

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "ResizeIter",
           "PrefetchingIter", "MNISTIter", "CSVIter", "LibSVMIter",
           "ImageRecordIter", "TokenRecordIter", "DeviceStager",
           "write_token_shard"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """Name, shape, dtype and layout of one input."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)


class DataBatch:
    """One batch: lists of data and label NDArrays, and the count of
    padding rows at its end."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        for what, v in (("data", data), ("label", label)):
            if v is not None and not isinstance(v, (list, tuple)):
                raise TypeError(f"DataBatch {what} must be a list of "
                                f"NDArrays, got {type(v).__name__}")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        labels = [lb.shape for lb in self.label] if self.label else None
        return (f"{type(self).__name__}: data shapes: "
                f"{[d.shape for d in self.data]} label shapes: {labels}")


class DataIter:
    """Base iterator: ``next()`` builds a batch from ``iter_next`` and
    the ``get*`` methods."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _init_data(data, allow_empty, default_name):
    """``[(name, numpy array)]`` from an array, a list or a dict."""
    if data is None:
        if not allow_empty:
            raise ValueError("data must not be None")
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if len(data) <= 1:
            data = {default_name: d for d in data}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    return [(k, v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v))
            for k, v in data.items()]


class NDArrayIter(DataIter):
    """Batches over in-memory arrays; the last partial batch is padded
    from the start ("pad"), dropped ("discard") or carried into the next
    epoch ("roll_over"); ``shuffle`` permutes the rows each epoch."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", rng=None):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.num_data = self.idx.shape[0]
        if self.num_data < batch_size:
            raise ValueError(f"batch_size {batch_size} exceeds the "
                             f"{self.num_data} rows of data")
        self._rng = rng if rng is not None else _np.random
        self.cursor = -batch_size
        self._residual = _np.array([], dtype=self.idx.dtype)
        self._order = self.idx
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            self._rng.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and len(self._residual):
            self._order = _np.concatenate([self._residual, self.idx])
            self._residual = _np.array([], dtype=self.idx.dtype)
        else:
            self._order = self.idx
        self.num_batch_data = len(self._order)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.cursor >= self.num_batch_data:
            return False
        if self.cursor + self.batch_size > self.num_batch_data:
            if self.last_batch_handle == "roll_over":
                # a copy: reset() shuffles self.idx in place
                self._residual = self._order[self.cursor:].copy()
                return False
            if self.last_batch_handle == "discard":
                return False
        return True

    def _getdata(self, source):
        end = self.cursor + self.batch_size
        sel = self._order[self.cursor:end]
        if end > self.num_batch_data:  # "pad": wrap around to the start
            sel = _np.concatenate(
                [sel, self._order[:end - self.num_batch_data]])
        return [nd.array(v[sel], dtype=v.dtype) for _, v in source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label) if self.label else []

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_batch_data:
            return self.cursor + self.batch_size - self.num_batch_data
        return 0

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def state_dict(self, consumed=None):
        """The position (cursor, epoch order, roll_over carry) as a
        JSON-able dict: loaded into a fresh iterator, the rest of the
        stream is the same, bit for bit. ``consumed`` (batches handed out
        this epoch) overrides the cursor, for a wrapper that has staged
        batches not handed out yet."""
        cursor = self.cursor if consumed is None \
            else -self.batch_size + int(consumed) * self.batch_size
        return {"kind": "NDArrayIter", "cursor": int(cursor),
                "idx": [int(i) for i in self.idx],
                "order": [int(i) for i in self._order],
                "residual": [int(i) for i in self._residual]}

    def load_state_dict(self, state):
        self.idx = _np.asarray(state["idx"], dtype=self.idx.dtype)
        self._order = _np.asarray(state["order"], dtype=self.idx.dtype)
        self._residual = _np.asarray(state["residual"], dtype=self.idx.dtype)
        self.num_batch_data = len(self._order)
        self.cursor = int(state["cursor"])


# ----------------------------------------------- record readers' epochs --

def _gang_shard(num_parts, part_index):
    """The reader's shard: the arguments, else the worker group's
    ``MXTPU_NUM_WORKERS`` / ``MXTPU_WORKER_ID``."""
    if num_parts is None:
        num_parts = int(os.environ.get("MXTPU_NUM_WORKERS", "1") or 1)
        if part_index is None:
            part_index = int(os.environ.get("MXTPU_WORKER_ID", "0") or 0)
    num_parts = max(1, int(num_parts))
    part_index = int(part_index or 0)
    if not 0 <= part_index < num_parts:
        raise ValueError(f"part_index {part_index} is outside "
                         f"num_parts {num_parts}")
    return num_parts, part_index


_RNG_TLS = threading.local()


class _ShardedEpochMixin:
    """Deterministic epochs of the record readers.

    * An epoch's global record order is a function of ``(seed, epoch)``:
      every part computes the same shuffle.
    * Part ``part_index`` of ``num_parts`` reads block-cyclic slices: its
      k-th batch is global records ``[(k * num_parts + part_index) *
      batch_size, ... + batch_size)`` of the epoch's order, so the parts
      tile the epoch with no overlap.
    * The position is saved as a global record position (``state_dict``),
      so a stream cut at G resumes at G on any geometry whose global
      batch (``batch_size * num_parts``) divides G.
    """

    def _init_epoch_state(self, seed, shuffle, num_parts, part_index):
        self._seed = int(seed) & 0x7FFFFFFF
        self._shuffle = bool(shuffle)
        self._num_parts, self._part_index = _gang_shard(num_parts,
                                                        part_index)
        self._epoch = -1     # reset() (called by __init__) opens epoch 0
        self._step = 0       # producer cursor: batches staged this epoch
        self._consumed = 0   # consumer cursor: batches handed out
        self._order = []

    def _epoch_rng(self, *extra):
        """A generator keyed by ``(seed, epoch, *extra)``: any position's
        draws are made without replaying the epoch. One RandomState per
        thread, seeded anew (the stream of ``RandomState(key)``, at a
        tenth of the cost of making one)."""
        key = [self._seed, self._epoch & 0x7FFFFFFF]
        key += [int(x) & 0x7FFFFFFF for x in extra]
        tls = _RNG_TLS.__dict__
        rng = tls.get("rng")
        if rng is None:
            rng = tls["rng"] = _np.random.RandomState()
        rng.seed(_np.array(key, dtype=_np.uint32))
        return rng

    def _keys(self):
        raise NotImplementedError

    def _set_epoch_order(self):
        order = list(self._keys())
        if self._shuffle:
            self._epoch_rng().shuffle(order)
        self._order = order

    def _begin_epoch(self):
        self._epoch += 1
        self._step = 0
        self._consumed = 0
        self._set_epoch_order()

    def _steps_per_epoch(self):
        gb = self.batch_size * self._num_parts
        n = len(self._order)
        return -(-n // gb) if self._round_batch else n // gb

    def _next_keys(self):
        """``(global epoch position, record keys)`` of this part's next
        batch, or None at the epoch's end; ``round_batch`` wraps the last
        partial global batch round to the epoch's start."""
        if self._step >= self._steps_per_epoch():
            return None
        n = len(self._order)
        g0 = (self._step * self._num_parts + self._part_index) \
            * self.batch_size
        keys = [self._order[(g0 + j) % n] for j in range(self.batch_size)]
        self._step += 1
        return g0, keys

    def _halt_pipeline(self):
        """Stop a producer before the position moves."""

    def state_dict(self, consumed=None):
        """``(seed, epoch, consumed global record position)`` as a
        JSON-able dict: a fresh iterator that loads it (of any
        ``num_parts`` whose global batch divides the position) continues
        the stream, records and augmentation draws, bit for bit.
        ``consumed`` overrides the count of batches handed out."""
        consumed = self._consumed if consumed is None else int(consumed)
        return {"kind": type(self).__name__,
                "seed": self._seed,
                "epoch": self._epoch,
                "consumed": consumed,
                "batch_size": self.batch_size,
                "num_parts": self._num_parts,
                "global_pos": consumed * self.batch_size * self._num_parts}

    def load_state_dict(self, state):
        if "global_pos" in state:
            pos = int(state["global_pos"])
        else:
            pos = int(state["consumed"]) \
                * int(state.get("batch_size", self.batch_size)) \
                * int(state.get("num_parts", 1))
        if int(state.get("seed", self._seed)) != self._seed:
            warnings.warn(
                f"{type(self).__name__}.load_state_dict: the state was cut "
                f"with seed {state.get('seed')} but this iterator uses seed "
                f"{self._seed}; the shuffle and augmentation stream will "
                "not match the original run", stacklevel=2)
        gb = self.batch_size * self._num_parts
        if pos % gb:
            raise ValueError(
                f"the saved data position ({pos} records into the epoch) "
                f"does not fall on this geometry's global batch boundary "
                f"(batch_size {self.batch_size} x num_parts "
                f"{self._num_parts} = {gb})")
        self._halt_pipeline()
        self._epoch = int(state["epoch"])
        self._step = self._consumed = pos // gb
        self._set_epoch_order()


# ------------------------------------------------------------- wrappers --

class ResizeIter(DataIter):
    """``size`` batches an epoch from ``data_iter``, resetting it when it
    runs out."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        for attr in ("provide_data", "provide_label", "default_bucket_key"):
            if hasattr(data_iter, attr):
                setattr(self, attr, getattr(data_iter, attr))

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _not_ported_staging(what):
    return MXNetError(
        f"DeviceStager({what}=): multi-card data parallelism (a batch "
        "split over a mesh of cards) is not ported; stage onto one card "
        "with device=")


class DeviceStager:
    """Stages host arrays onto one card (``device``, a Context): each
    array goes through page-locked host memory and is copied on the
    stager's own CUDA stream, so a copy made from a worker thread never
    touches the consumer's stream (or a CUDA graph it is capturing).
    ``claim`` makes the consumer's current stream the tensor's user.
    Without a device the stager is inactive and ``put`` passes through.
    ``mesh=`` and ``shardings=`` (several cards) raise."""

    def __init__(self, device=None, mesh=None, shardings=None):
        if mesh is not None:
            raise _not_ported_staging("mesh")
        if shardings is not None:
            raise _not_ported_staging("shardings")
        self._device = None if device is None else (
            device.torch_device() if isinstance(device, Context)
            else torch.device(device))
        self._stream = None

    @property
    def active(self):
        return self._device is not None

    def put(self, raw, is_label=False):
        """``raw`` (a tensor) on the stager's device."""
        if not self.active or raw.device == self._device:
            return raw
        if self._device.type == "cpu":
            return raw.to(self._device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        src = raw if raw.is_pinned() else raw.pin_memory()
        with torch.cuda.stream(self._stream):
            out = src.to(self._device, non_blocking=True)
        self._stream.synchronize()
        return out

    def claim(self, t):
        """Mark the consumer's current stream as a user of ``t`` (its
        memory is then not reused before that stream's work is done)."""
        if t.device.type == "cuda" and self._stream is not None:
            t.record_stream(torch.cuda.current_stream(t.device))
        return t


class PrefetchingIter(DataIter):
    """Fetches the next batch of each wrapped iterator in background
    threads while the consumer works on this one; with ``device=`` (a
    Context) each fetched batch is also staged onto that card in the
    fetch thread (``DeviceStager``). A worker's error is raised at the
    next ``next()`` and again until :meth:`reset`."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 device=None, mesh=None, shardings=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        if not iters:
            raise ValueError("PrefetchingIter needs at least one iterator")
        self.n_iter = len(iters)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = iters[0].batch_size
        self._next_batches = [None] * self.n_iter
        self._threads = []
        self._started = False
        self._delivered = 0
        self._error = None
        self._stager = DeviceStager(device=device, mesh=mesh,
                                    shardings=shardings)
        self.data_wait_ms = []

    def _stage_batch(self, batch):
        if batch is None or not self._stager.active:
            return batch
        put = self._stager.put
        if batch.data:
            batch.data = [NDArray(put(d._data)) for d in batch.data]
        if batch.label:
            batch.label = [NDArray(put(lb._data, True)) for lb in batch.label]
        return batch

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r[x.name], str) else r[x.name]
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(r[x.name], str) else r[x.name]
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def _fetch(self):
        # a fresh slot list each round: an abandoned worker writes only
        # into its own round's list
        slots = self._next_batches = [None] * self.n_iter
        ctx = current_context()   # a source makes its batch on the caller's

        def worker(i, out):
            try:
                if _faults.ARMED:
                    _faults.point("io.fetch")   # a flaky or wedged source
                with ctx:
                    out[i] = self._stage_batch(self.iters[i].next())
                _watchdog.beat("io.fetch", f"worker {i} staged")
            except StopIteration:
                out[i] = None
            except BaseException as e:  # raised at the consumer's next()
                out[i] = e

        self._threads = [threading.Thread(target=worker, args=(i, slots),
                                          daemon=True,
                                          name=f"mxnet-prefetch-{i}")
                         for i in range(self.n_iter)]
        for t in self._threads:
            t.start()

    def _join(self):
        threads = self._threads
        if not threads:
            return

        def join_all():
            for t in threads:
                t.join()

        try:
            _watchdog.sync("io.fetch", join_all, label="prefetch join")
        finally:
            self._threads = []

    def reset(self):
        """Clear a sticky error, abandon workers a stall left wedged,
        reset the sources and stage the first batch again."""
        stalled = isinstance(self._error, _watchdog.StallError)
        self._error = None
        if stalled:
            self._threads = []
        else:
            self._join()
        for it in self.iters:
            it.reset()
        self._delivered = 0
        self._fetch()
        self._started = True

    def _advance(self):
        """The staged batch (staging the next one), or None at the end.
        An error here sticks until reset()."""
        if self._error is not None:
            raise self._error
        try:
            if not self._started:
                self._fetch()
                self._started = True
            t0 = time.perf_counter()
            self._join()
            self.data_wait_ms.append((time.perf_counter() - t0) * 1e3)
            _tsteps.phase("data_wait", self.data_wait_ms[-1])
            batches = list(self._next_batches)
            for b in batches:
                if isinstance(b, BaseException):
                    raise b
            if any(b is None for b in batches):
                if not all(b is None for b in batches):
                    raise MXNetError("PrefetchingIter: the wrapped "
                                     "iterators ran out at different "
                                     "batches")
                return None
            self._fetch()
        except BaseException as e:
            self._error = e
            raise
        for b in batches:
            for arr in (b.data or []) + (b.label or []):
                self._stager.claim(arr._data)
        self._delivered += 1
        if self.n_iter == 1:
            return batches[0]
        return DataBatch(data=sum([b.data for b in batches], []),
                         label=sum([(b.label or []) for b in batches], []),
                         pad=batches[0].pad)

    def iter_next(self):
        self.current_batch = self._advance()
        return self.current_batch is not None

    def next(self):
        if getattr(self, "current_batch", None) is None:
            if not self.iter_next():
                raise StopIteration
        batch, self.current_batch = self.current_batch, None
        return batch

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    def state_dict(self):
        """The position at the consumer: batches fetched and not handed
        out yet are excluded (they come again after a load). The wrapped
        iterators need ``state_dict(consumed=...)``."""
        return {"kind": "PrefetchingIter", "delivered": self._delivered,
                "iters": [it.state_dict(consumed=self._delivered)
                          for it in self.iters]}

    def load_state_dict(self, state):
        """Restore a position; a fetched batch is dropped and the next
        ``next()`` fetches from the restored position."""
        try:
            self._join()
        except BaseException:
            pass
        self._threads = []
        self._error = None
        self._next_batches = [None] * self.n_iter
        self._started = False
        self.current_batch = None
        for it, s in zip(self.iters, state["iters"]):
            it.load_state_dict(s)
        self._delivered = int(state["delivered"])


# ------------------------------------------------------- file iterators --

def _read_mnist_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad MNIST image magic {magic} in {path}")
        return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(num, rows,
                                                                 cols)


def _read_mnist_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, _num = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad MNIST label magic {magic} in {path}")
        return _np.frombuffer(f.read(), dtype=_np.uint8)


class MNISTIter(NDArrayIter):
    """MNIST's idx files (``.gz`` too) as float32 images in [0, 1]
    (NCHW, or flat), labels named ``softmax_label``."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, seed=0, silent=False,
                 num_parts=1, part_index=0, **kwargs):
        images = _read_mnist_images(image).astype(_np.float32) / 255.0
        labels = _read_mnist_labels(label).astype(_np.float32)
        if num_parts > 1:
            images = images[part_index::num_parts]
            labels = labels[part_index::num_parts]
        images = images.reshape(len(images), -1) if flat \
            else images[:, None, :, :]
        super().__init__(images, labels, batch_size=batch_size,
                         shuffle=shuffle, last_batch_handle="discard",
                         data_name="data", label_name="softmax_label",
                         rng=_np.random.RandomState(seed))


class CSVIter(NDArrayIter):
    """Rows of a CSV file as ``data_shape`` samples (and labels from a
    second file)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=128, round_batch=True,
                 **kwargs):
        data = _np.loadtxt(data_csv, delimiter=",", dtype=_np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=_np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
        super().__init__(data, label, batch_size=batch_size,
                         last_batch_handle="pad" if round_batch
                         else "discard")


class LibSVMIter(DataIter):
    """LibSVM text (``<label> <idx>:<val> ...`` a line, indices 0-based)
    in batches of CSR features and a dense label (JAX :846-924; MXNet 1.x
    ``src/io/iter_libsvm.cc``).

    ``data_shape`` is the feature count; ``label_libsvm`` names a file
    whose lines' first values replace the labels. With ``round_batch``
    the last batch wraps to the epoch's first rows and ``pad`` counts
    them, else a short last batch is dropped. The file is read once at
    construction. Each batch is a :class:`~mxnet_tpu_torch.ndarray.sparse.
    CSRNDArray` of ``(batch_size, features)`` and a float32 label on
    ``ctx`` (the current context when the batch is made, by default)."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=(1,), batch_size=128, round_batch=True,
                 ctx=None, **kwargs):
        super().__init__(batch_size)
        if isinstance(data_shape, int):
            data_shape = (data_shape,)
        self._num_features = int(data_shape[-1])
        labels, counts, pairs = [], [], []
        with open(data_libsvm) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                counts.append(len(parts) - 1)
                pairs.extend(parts[1:])
        # "i:v" pairs parsed in one pass: indices exact below 2**53, each
        # value a double rounded once to float32, as float(v) would be
        flat = _np.array(" ".join(pairs).replace(":", " ").split(),
                         dtype=_np.float64).reshape(-1, 2)
        if label_libsvm is not None:
            with open(label_libsvm) as f:
                labels = [float(ln.split()[0]) for ln in f if ln.strip()]
        self._labels = _np.asarray(labels, _np.float32)
        self._indptr = _np.concatenate(
            [[0], _np.cumsum(counts, dtype=_np.int64)]).astype(_np.int64)
        self._indices = flat[:, 0].astype(_np.int64)
        self._values = flat[:, 1].astype(_np.float32)
        self._num = len(self._labels)
        self._round_batch = round_batch
        self._ctx = ctx
        self._cursor = 0
        self.provide_data = [DataDesc("data",
                                      (batch_size, self._num_features))]
        self.provide_label = [DataDesc("label",
                                       (batch_size,) + tuple(label_shape))]

    def reset(self):
        self._cursor = 0

    def _gather_rows(self, rows):
        """``(values, indices, indptr)`` of ``rows``, in that order."""
        lo, hi = self._indptr[rows], self._indptr[rows + 1]
        lens = hi - lo
        ptr = _np.concatenate([[0], _np.cumsum(lens)]).astype(_np.int64)
        pos = _np.repeat(lo - ptr[:-1], lens) + _np.arange(ptr[-1])
        return self._values[pos], self._indices[pos], ptr

    def next(self):
        from ..ndarray.sparse import CSRNDArray

        if self._cursor >= self._num:
            raise StopIteration
        s, e = self._cursor, self._cursor + self.batch_size
        pad = 0
        if e > self._num:
            if not self._round_batch:
                raise StopIteration
            pad, e = e - self._num, self._num   # wrap to the epoch start
        rows = _np.concatenate([_np.arange(s, e), _np.arange(pad)]) \
            .astype(_np.int64)
        self._cursor = s + self.batch_size
        vals, ind, ptr = self._gather_rows(rows)
        ctx = self._ctx or current_context()
        csr = CSRNDArray(vals, ind, ptr, (self.batch_size, self._num_features),
                         ctx=ctx)
        label = NDArray(self._labels[rows], ctx=ctx)
        return DataBatch(data=[csr], label=[label], pad=pad, index=None)


# ------------------------------------------------------ ImageRecordIter --

_HostBatch = namedtuple("_HostBatch", ["data", "label", "slot", "stages"])
_RUNS_PER_THREAD = 4


class _PinnedSlots:
    """Page-locked host buffers that a card iterator's batches are
    normalised into and copied from. A buffer comes back with the event
    of its copy and is written again only after that event."""

    def __init__(self, n, data_shape, label_shape):
        self._free = queue.Queue()
        for _ in range(n):
            self._free.put((
                torch.empty(data_shape, dtype=torch.float32,
                            pin_memory=True),
                torch.empty(label_shape, dtype=torch.float32,
                            pin_memory=True), None))

    def take(self):
        data, label, event = self._free.get()
        if event is not None:
            event.synchronize()
        return data, label

    def give(self, slot, event=None):
        self._free.put((slot[0], slot[1], event))


class ImageRecordIter(_ShardedEpochMixin, DataIter):
    """Batches of images from a ``.rec`` file (MXNet 1.x's
    ``ImageRecordIter``).

    Each record is routed by its payload's magic bytes. JPEG records go
    through the native OpenMP batch decode (align-corners bilinear to the
    decode size, then crop, mirror and jitter fused); PNG records through
    ``preprocess_threads`` threads, each inflating with ``zlib`` and then
    unfiltering, resampling with Pillow's ``BILINEAR`` and augmenting in
    one native call that also writes the image normalised (float32 CHW,
    RGB), with the arithmetic of the JAX package's PIL path and native
    normalisation. A record that is neither, or is damaged, is zero-filled
    with a warning; a valid PNG variant that is not ported (interlaced,
    16-bit) raises. On a card the batch is written into page-locked memory
    and copied in ``next()`` on the consumer's stream.

    A producer thread prepares up to ``prefetch_buffer`` batches ahead (it
    holds the iterator only by a weak reference). The shuffle is a
    function of ``(seed, epoch)`` and each image's draws of ``(seed,
    epoch, position)``, so ``state_dict``/``load_state_dict`` resume
    mid-epoch bit for bit and ``num_parts``/``part_index`` tile the epoch.
    ``ctx`` (default: the current context at construction) places the
    batches. ``stage_ms()`` gives each batch's time by stage and
    ``data_wait_ms`` the time ``next()`` waited for the producer.
    """

    def __init__(self, path_imgrec, data_shape, path_imgidx=None,
                 batch_size=128, shuffle=False, label_width=1,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 round_batch=True, seed=0, rand_crop=False,
                 rand_mirror=False, color_jitter=0.0,
                 num_parts=None, part_index=None,
                 preprocess_threads=4, prefetch_buffer=2, ctx=None,
                 **kwargs):
        from .. import recordio

        super().__init__(batch_size)
        self._data_shape = tuple(data_shape)
        if len(self._data_shape) != 3 or self._data_shape[0] != 3:
            raise ValueError(f"data_shape must be (3, h, w), got "
                             f"{self._data_shape}")
        if path_imgidx is None:
            path_imgidx = path_imgrec[:-4] + ".idx" \
                if path_imgrec.endswith(".rec") else path_imgrec + ".idx"
        self._rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
        self._label_width = label_width
        self._mean = _np.asarray([mean_r, mean_g, mean_b], _np.float32)
        self._std = _np.asarray([std_r, std_g, std_b], _np.float32)
        self._scale = scale
        self._round_batch = round_batch
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._color_jitter = float(color_jitter)
        self._threads = max(int(preprocess_threads), 1)
        self._prefetch = max(int(prefetch_buffer), 0)
        self._ctx = ctx if ctx is not None else current_context()
        self._device = self._ctx.torch_device()
        self._queue = None
        self._producer = None
        self._executor = None
        self._fd = None
        self._span = None
        self._fd_lock = threading.Lock()
        self._slots = None
        self._stats = []
        self.data_wait_ms = []
        self._init_epoch_state(seed, shuffle, num_parts, part_index)
        self.provide_data = [DataDesc("data",
                                      (batch_size,) + self._data_shape)]
        lshape = (batch_size,) if label_width == 1 \
            else (batch_size, label_width)
        self.provide_label = [DataDesc("label", lshape)]
        self.reset()

    def _keys(self):
        return list(self._rec.keys)

    def _halt_pipeline(self):
        self._stop_producer()

    def reset(self):
        self._stop_producer()
        self._begin_epoch()

    # ---------------------------------------------------------- decode --
    def _decode_size(self):
        """The decode size: with rand_crop larger than the output, so the
        crop has room."""
        _c, h, w = self._data_shape
        if self._rand_crop:
            return h + max(8, h // 8), w + max(8, w // 8)
        return h, w

    def _augmenting(self):
        return bool(self._rand_crop or self._rand_mirror
                    or self._color_jitter)

    def _draw(self, pos):
        """The draws ``(y, x, mirror, jitter)`` of the image at epoch
        position ``pos``, from a generator keyed by (seed, epoch, pos)."""
        _c, h, w = self._data_shape
        dh, dw = self._decode_size()
        y = x = m = 0
        jit = _np.ones(3, _np.float32)
        if self._augmenting():
            rng = self._epoch_rng(pos)
            if self._rand_crop:
                y = rng.randint(0, dh - h + 1)
                x = rng.randint(0, dw - w + 1)
            if self._rand_mirror:
                m = int(rng.rand() < 0.5)
            if self._color_jitter:
                jit = rng.uniform(1.0 - self._color_jitter,
                                  1.0 + self._color_jitter,
                                  3).astype(_np.float32)
        return int(y), int(x), m, jit if self._color_jitter else None

    def _read(self, key):
        """Record ``key``'s header and payload, ``(IRHeader, memoryview)``,
        by one ``os.pread`` of the record (its length from the next
        record's offset): no shared file position, so the decode threads
        read without a lock, and the payload is not copied."""
        from .. import recordio

        fd, span = self._fd, self._span
        if fd is None:
            with self._fd_lock:       # opened once, by the first reader
                if self._fd is None:
                    fd = os.open(self._rec.uri, os.O_RDONLY)
                    offs = sorted(self._rec.idx.values()) + [
                        os.fstat(fd).st_size]
                    self._span = {a: b - a for a, b in zip(offs, offs[1:])}
                    self._fd = fd
                fd, span = self._fd, self._span
        off = self._rec.idx[key]
        body = memoryview(os.pread(fd, span[off], off))
        magic, lrec = struct.unpack_from("<II", body) if len(body) >= 8 \
            else (0, 0)
        length = lrec & ((1 << 29) - 1)
        if magic != 0xCED7230A or len(body) < 8 + length:
            raise ValueError(f"{self._rec.uri}: bad record at {off}")
        return recordio.unpack(body[8:8 + length])

    def _retry_jpeg(self, jpg, failed, draws, sub, rows, rest, dh, dw,
                    h, w):
        """Decode again, one by one under ``faults.retry`` (2 retries,
        a 5 s deadline, JAX :1159), the JPEG records the batch decode
        rejected (positions ``failed`` of ``sub``); each one that decodes
        is written into ``rows``. Returns the positions still failing."""
        def decode_one(buf, d):
            if d is None:
                out, bad = native.decode_jpeg_batch(
                    [buf], dh, dw, n_threads=1)
            else:
                out, bad = native.decode_augment_batch(
                    [buf], dh, dw, h, w, [d[0]], [d[1]], [d[2]],
                    _np.stack([d[3]]) if self._color_jitter else None,
                    n_threads=1)
            if bad:
                raise ValueError("JPEG record rejected by the decoder")
            return out[0]

        decode_one = _faults.retry(decode_one, retries=2, backoff=0.01,
                                   deadline=5.0)
        still = []
        for f in failed:
            try:
                rows[rest.index(jpg[f])] = decode_one(
                    sub[f], None if draws is None else draws[f])
            except (ValueError, MXNetError):
                still.append(f)
        return still

    def _record_one(self, key, i, pos, data):
        """Read record ``key`` (the ``i``-th of the batch, at epoch
        position ``pos``) and make its draws; a PNG is also decoded and
        normalised into ``data[i]`` in one native call. Returns ``(kind,
        payload, label, draws, stage seconds)``: kind "png", "jpeg" (the
        payload kept for the batched decode) or None (damaged)."""
        t0 = time.perf_counter()
        header, buf = self._read(key)
        label = _np.asarray(header.label, _np.float32).reshape(-1)
        label = label[:self._label_width]
        t1 = time.perf_counter()
        draws = self._draw(pos)
        t2 = time.perf_counter()
        times = {"read": t1 - t0, "draws": t2 - t1}
        if native.is_jpeg(buf):
            return "jpeg", buf, label, draws, times
        if not native.is_png(buf):
            return None, None, label, draws, times
        _c, h, w = self._data_shape
        dh, dw = self._decode_size()
        y, x, m, jit = draws
        try:
            info = native.png_info(buf)
            raw = native.png_inflate(info)
            t3 = time.perf_counter()
            native.png_decode_augment(
                raw, info, dh, dw, h, w, y, x, m, jit, planes=data[i],
                normalize=(self._mean, self._std, self._scale))
        except ValueError:
            return None, None, label, draws, times
        times.update(inflate=t3 - t2, decode=time.perf_counter() - t3)
        return "png", None, label, draws, times

    def _produce(self, start, keys, slot=None):
        """``(epoch position, keys)`` -> one host batch, normalised into
        ``slot`` when given. The reads and the PNG decodes (normalised as
        they are written) run in the decode threads; JPEG records in one
        OpenMP call, then the normalisation of their rows."""
        if _faults.ARMED:
            # a raise surfaces at next(), through the producer thread
            _faults.point("io.decode")
        t0 = time.perf_counter()
        _c, h, w = self._data_shape
        dh, dw = self._decode_size()
        n = len(keys)
        data = slot[0].numpy() if slot is not None \
            else _np.empty((n, 3, h, w), _np.float32)
        args = [(k, i, start + i, data) for i, k in enumerate(keys)]
        if self._threads > 1 and n > 1:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    self._threads, thread_name_prefix="mxnet-decode")
            # a few runs of records a thread, not one task a record: fewer
            # hand-offs through the pool's queue under the GIL
            step = -(-n // (self._threads * _RUNS_PER_THREAD))
            results = [r for run in self._executor.map(
                lambda lo: [self._record_one(*a) for a in args[lo:lo + step]],
                range(0, n, step)) for r in run]
        else:
            results = [self._record_one(*a) for a in args]
        stages = {"records_wall": time.perf_counter() - t0}
        for name in ("read", "draws", "inflate", "decode", "normalize"):
            stages[name] = sum(r[4].get(name, 0.0) for r in results)
        jpg = [i for i, r in enumerate(results) if r[0] == "jpeg"]
        bad = [i for i, r in enumerate(results) if r[0] is None]
        rest = sorted(jpg + bad)
        rows = _np.zeros((len(rest), h, w, 3), _np.uint8)  # bad rows: 0
        if jpg:
            t = time.perf_counter()
            sub = [results[i][1] for i in jpg]
            if self._augmenting():
                d = [results[i][3] for i in jpg]
                out, failed = native.decode_augment_batch(
                    sub, dh, dw, h, w, [v[0] for v in d], [v[1] for v in d],
                    [v[2] for v in d],
                    _np.stack([v[3] for v in d]) if self._color_jitter
                    else None, n_threads=self._threads)
            else:
                out, failed = native.decode_jpeg_batch(
                    sub, dh, dw, n_threads=self._threads)
            rows[[rest.index(i) for i in jpg]] = out
            if failed:
                failed = self._retry_jpeg(
                    jpg, failed, [results[i][3] for i in jpg]
                    if self._augmenting() else None, sub, rows, rest,
                    dh, dw, h, w)
            bad += [jpg[f] for f in failed]      # zero-filled
            stages["jpeg"] = time.perf_counter() - t
        if bad:
            warnings.warn(f"ImageRecordIter: {len(bad)} corrupt image(s) "
                          "in batch zero-filled", stacklevel=2)
        if rest:
            t = time.perf_counter()
            data[rest] = native.normalize_batch(rows, self._mean, self._std,
                                                scale=self._scale)
            stages["normalize"] += time.perf_counter() - t
        label_arr = _np.stack([r[2] for r in results])
        if self._label_width == 1:
            label_arr = label_arr.reshape(-1)
        if slot is not None:
            slot[1].numpy()[...] = label_arr
        stages["produce"] = time.perf_counter() - t0
        stages["images"] = n
        return _HostBatch(slot[0] if slot is not None else data, label_arr,
                          slot, stages)

    def _deliver(self, item, wait_s):
        """A host batch as a DataBatch on the iterator's context; on a
        card the copy runs on the consumer's current stream."""
        self.data_wait_ms.append(wait_s * 1e3)
        _tsteps.phase("data_wait", wait_s * 1e3)
        if item.slot is None:     # the CPU
            data = NDArray(torch.from_numpy(item.data))
            label = NDArray(torch.from_numpy(item.label))
        else:
            stream = torch.cuda.current_stream(self._device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            d = torch.empty(item.slot[0].shape, dtype=torch.float32,
                            device=self._device)
            d.copy_(item.slot[0], non_blocking=True)
            lb = torch.empty(item.slot[1].shape, dtype=torch.float32,
                             device=self._device)
            lb.copy_(item.slot[1], non_blocking=True)
            end.record(stream)
            self._slots.give(item.slot, end)
            item.stages["h2d_events"] = (start, end)
            data, label = NDArray(d), NDArray(lb)
        self._stats.append(item.stages)
        return DataBatch(data=[data], label=[label], pad=0, index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def stage_ms(self):
        """Per batch handed out: ms of each stage (``read``, ``draws``,
        ``inflate``, ``decode`` and ``normalize`` summed over the decode
        threads; ``records_wall`` their wall time; ``jpeg`` the OpenMP
        decode; ``produce`` the whole batch; ``h2d`` the copy to the card
        by CUDA events)."""
        out = []
        for st in self._stats:
            row = {k: v * 1e3 for k, v in st.items()
                   if k not in ("h2d_events", "images")}
            row["images"] = st["images"]
            ev = st.get("h2d_events")
            if ev is not None:
                ev[1].synchronize()
                row["h2d"] = ev[0].elapsed_time(ev[1])
            out.append(row)
        return out

    # -------------------------------------------------------- producer --
    def _stop_producer(self):
        if self._producer is not None:
            self._drain = True
            while self._producer.is_alive():
                try:    # unblock a producer waiting on a full queue
                    item = self._queue.get_nowait()
                    if isinstance(item, _HostBatch) and item.slot is not None:
                        self._slots.give(item.slot)
                except queue.Empty:
                    pass
                self._producer.join(timeout=0.05)
            while True:   # batches left in the queue give their buffers back
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if isinstance(item, _HostBatch) and item.slot is not None:
                    self._slots.give(item.slot)
            self._producer = None
            self._queue = None

    def close(self):
        """Stop the producer and release the decode threads and the
        file."""
        self._stop_producer()
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        with self._fd_lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _slots_for_card(self):
        if self._device.type == "cpu":
            return None
        if self._slots is None:
            lshape = self.provide_label[0].shape
            self._slots = _PinnedSlots(self._prefetch + 2,
                                       (self.batch_size,) + self._data_shape,
                                       lshape)
        return self._slots

    def _start_producer(self):
        self._drain = False
        self._queue = queue.Queue(maxsize=self._prefetch)
        key_lists = []
        while True:
            keys = self._next_keys()
            if keys is None:
                break
            key_lists.append(keys)
        # a weak reference: a thread blocked on a full queue must not keep
        # a dropped iterator (its queue, buffers and file) alive
        wself = weakref.ref(self)
        q, slots = self._queue, self._slots_for_card()

        def run():
            for start, keys in key_lists:
                slot = slots.take() if slots is not None else None
                it = wself()
                if it is None or it._drain:
                    if slot is not None:
                        slots.give(slot)
                    return
                try:
                    item = it._produce(start, keys, slot)
                except BaseException as e:  # raised at next()
                    if slot is not None:
                        slots.give(slot)
                    q.put(e)
                    return
                del it
                q.put(item)
            q.put(None)   # the epoch's end

        self._producer = threading.Thread(target=run, daemon=True,
                                          name="mxnet-imagerecord")
        self._producer.start()

    def next(self):
        if self._prefetch:
            if self._producer is None:
                self._start_producer()
            t0 = time.perf_counter()
            item = self._queue.get()
            wait = time.perf_counter() - t0
            if item is None:
                self._producer = None
                raise StopIteration
            if isinstance(item, BaseException):
                self._producer = None
                raise item
            self._consumed += 1
            return self._deliver(item, wait)
        nk = self._next_keys()
        if nk is None:
            raise StopIteration
        slots = self._slots_for_card()
        item = self._produce(*nk, slots.take() if slots is not None
                             else None)
        self._consumed += 1
        return self._deliver(item, 0.0)


# ----------------------------------------------------- TokenRecordIter --

class TokenRecordIter(_ShardedEpochMixin, DataIter):
    """Fixed-length token blocks from a RecordIO shard (pack it with
    :func:`write_token_shard`): each record holds ``seq_len + 1``
    little-endian tokens of ``dtype``; a batch is ``data = block[:, :-1]``
    and ``label = block[:, 1:]``. Its epochs, sharding and
    ``state_dict`` are :class:`ImageRecordIter`'s."""

    def __init__(self, path_rec, seq_len, batch_size=32, shuffle=False,
                 seed=0, dtype=_np.int32, round_batch=False,
                 num_parts=None, part_index=None, **kwargs):
        super().__init__(batch_size)
        self._path = path_rec
        self._seq_len = int(seq_len)
        self._dtype = _np.dtype(dtype)
        self._round_batch = round_batch
        self._offsets, self._lengths = native.recordio_scan(path_rec)
        want = (self._seq_len + 1) * self._dtype.itemsize
        bad = [int(i) for i, ln in enumerate(self._lengths)
               if int(ln) != want]
        if bad:
            raise ValueError(
                f"{path_rec!r}: record(s) {bad[:5]} are not fixed-length "
                f"token blocks of {self._seq_len + 1} x "
                f"{self._dtype.name} ({want} bytes); pack shards with "
                "io.write_token_shard")
        self._init_epoch_state(seed, shuffle, num_parts, part_index)
        self.provide_data = [DataDesc("data", (batch_size, self._seq_len),
                                      self._dtype)]
        self.provide_label = [DataDesc("label", (batch_size, self._seq_len),
                                       self._dtype)]
        self.reset()

    def _keys(self):
        return list(range(len(self._offsets)))

    def reset(self):
        self._begin_epoch()

    def next(self):
        nk = self._next_keys()
        if nk is None:
            raise StopIteration
        _start, keys = nk
        if _faults.ARMED:
            _faults.point("io.decode")
        payloads = native.recordio_read(self._path, self._offsets[keys],
                                        self._lengths[keys])
        blocks = _np.stack([_np.frombuffer(p, self._dtype)
                            for p in payloads])
        self._consumed += 1
        return DataBatch(data=[nd.array(blocks[:, :-1], dtype=self._dtype)],
                         label=[nd.array(blocks[:, 1:], dtype=self._dtype)],
                         pad=0, index=None)


def write_token_shard(path, tokens, seq_len, dtype=_np.int32):
    """Pack a token stream into a RecordIO shard for
    :class:`TokenRecordIter`: windows of ``seq_len + 1`` tokens at stride
    ``seq_len`` (a short tail is dropped). Returns the number of blocks."""
    tokens = _np.ascontiguousarray(tokens, dtype)
    payloads = [tokens[s:s + seq_len + 1].tobytes()
                for s in range(0, len(tokens) - seq_len, seq_len)]
    with open(path, "wb") as f:
        f.write(native.recordio_pack(payloads))
    return len(payloads)
