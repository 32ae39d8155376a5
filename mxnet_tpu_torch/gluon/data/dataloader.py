"""The DataLoader.

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py``: batches from a
dataset through a batch sampler and ``batchify_fn``. Workers are threads,
as in the JAX package (MXNet forks processes); each builds its batch on
the context that was current where the iteration started. ``pin_memory``
puts each batch's arrays in page-locked host memory (``torch``'s pinned
memory), from which a copy to the card is asynchronous; it needs a card.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as _np
import torch

from ... import ndarray as nd
from ...base import MXNetError
from ...context import cpu, current_context
from ...ndarray import NDArray
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples (NDArrays, numpy arrays or numbers; tuples field by
    field) into one batch."""
    if isinstance(data[0], NDArray):
        return nd.stack(*data)
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    data = _np.asarray(data)
    return nd.array(data, dtype=data.dtype)


def _pinned(batch):
    if isinstance(batch, NDArray):
        return NDArray(batch._data.pin_memory())
    if isinstance(batch, (list, tuple)):
        return type(batch)(_pinned(b) for b in batch)
    return batch


class DataLoader:
    """Batches of ``dataset`` in the order of ``sampler`` (or shuffled),
    loaded by ``num_workers`` threads with ``prefetch`` batches ahead."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True):
        self._dataset = dataset
        if pin_memory and not torch.cuda.is_available():
            raise MXNetError("pin_memory=True needs a CUDA card (pinned "
                             "memory is page-locked for copies to it)")
        self._pin_memory = pin_memory
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch or 2 * max(self._num_workers, 1))
        self._batchify_fn = batchify_fn or default_batchify_fn

    def _load(self, ctx, indices):
        with ctx:
            batch = self._batchify_fn([self._dataset[i] for i in indices])
        return _pinned(batch) if self._pin_memory else batch

    def __iter__(self):
        ctx = cpu() if self._pin_memory else current_context()
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._load(ctx, batch)
            return
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            pending = []
            it = iter(self._batch_sampler)
            for indices in it:
                pending.append(pool.submit(self._load, ctx, indices))
                if len(pending) >= self._prefetch:
                    break
            while pending:
                fut = pending.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load, ctx, nxt))
                yield fut.result()

    def __len__(self):
        return len(self._batch_sampler)
