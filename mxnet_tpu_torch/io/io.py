"""In-memory data iterators.

Counterpart of ``mxnet_tpu/io/io.py``: ``DataDesc`` :255, ``DataBatch``
:268, ``DataIter`` :295 and ``NDArrayIter`` :356 (with ``_init_data``
:332), the part the quantization calibration reads. Batches are
NDArrays on the current context (the card unless a ``with mx.cpu():``
says otherwise).
"""
from __future__ import annotations

from collections import namedtuple

import numpy as _np

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


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
