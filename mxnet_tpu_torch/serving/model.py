"""ServedModel / ModelContainer: models served at a ladder of padded
batch buckets.

Counterpart of ``mxnet_tpu/serving/model.py``. A :class:`ServedModel`
wraps one inference forward ``fwd(tensor) -> tensor(s)`` on one device
(the card unless ``ctx=mx.cpu()``). Only the ``from_block`` loader is
ported: it snapshots the block's parameters onto the device at build
time, so later changes to the live parameters do not leak into serving,
and runs the block on that snapshot through
:func:`~mxnet_tpu_torch.gluon.parameter.substitute`.

Requests carry a leading batch dim ``(k,) + example_shape``; the batcher
coalesces rows into the smallest bucket that holds them. The smallest
default bucket is 2, as in the JAX package.
"""
from __future__ import annotations

import time
from collections import OrderedDict

import numpy as _np
import torch

from .. import autograd
from ..base import canonical_dtype, dtype_name, numpy_dtype
from ..context import current_context
from ..gluon.parameter import substitute
from ..ndarray import NDArray
from .config import DEFAULTS, coerce
from .errors import ModelNotFound

__all__ = ["ServedModel", "ModelContainer"]


class ServedModel:
    """One inference model: a forward on ``device``, its input row shape
    and dtype, and its padded-bucket ladder."""

    def __init__(self, name, forward, example_shape, dtype="float32",
                 buckets=None, device=None):
        self.name = str(name)
        self.example_shape = tuple(int(s) for s in example_shape)
        self.dtype = dtype_name(dtype)
        self.buckets = coerce("buckets", buckets or DEFAULTS["buckets"])
        self.device = device if device is not None else \
            current_context().torch_device()
        self._fwd = forward
        self._h2d = None  # side stream for host-to-device copies

    @property
    def max_bucket(self):
        return self.buckets[-1]

    def bucket_for(self, rows):
        """Smallest bucket >= rows, or None when rows exceeds the ladder."""
        for b in self.buckets:
            if b >= rows:
                return b
        return None

    def validate(self, arr):
        """Coerce one request payload to a host array ``(k,) +
        example_shape``; raises ValueError on a shape or size mismatch."""
        arr = _np.asarray(arr)
        if arr.shape == self.example_shape:
            arr = arr[None]
        if arr.shape[1:] != self.example_shape:
            raise ValueError(f"model {self.name!r} expects rows shaped "
                             f"{self.example_shape}, got {arr.shape}")
        if arr.shape[0] < 1:
            raise ValueError(f"model {self.name!r}: empty request")
        if arr.shape[0] > self.max_bucket:
            raise ValueError(
                f"model {self.name!r}: request of {arr.shape[0]} rows "
                f"exceeds the largest bucket {self.max_bucket}; split it "
                "client-side")
        return arr.astype(numpy_dtype(self.dtype), copy=False)

    def host_batch(self, bucket):
        """A zeroed host tensor for one padded batch, in pinned memory
        when the model runs on a card (so its copy can be asynchronous)."""
        return torch.zeros((bucket,) + self.example_shape,
                           dtype=canonical_dtype(self.dtype),
                           pin_memory=self.device.type == "cuda")

    def stage(self, host):
        """Start copying a host batch to the device. Returns ``(tensor,
        ready)``: on a card the copy runs on a side stream and ``ready``
        is the CUDA event that marks its end; on the CPU ``ready`` is
        None."""
        if self.device.type != "cuda":
            return host, None
        if self._h2d is None:
            self._h2d = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._h2d):
            x = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._h2d)
        return x, ready

    def run(self, x, rows=None, ready=None):
        """Run the forward on a (padded) batch and return the outputs as
        host numpy arrays sliced to ``rows``. ``x`` is a host array or a
        device tensor from :meth:`stage` with its ``ready`` event. Waits
        for the device (the copy to host)."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(_np.asarray(x))
        x = x.to(self.device)
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            x.record_stream(stream)
        with torch.inference_mode(), autograd.pause(train_mode=False):
            outs = self._fwd(x)
        n = x.shape[0] if rows is None else rows
        return [o[:n].to("cpu", dtype=canonical_dtype(
            numpy_dtype(o.dtype))).numpy() for o in outs]

    def warmup(self):
        """Run every bucket once on the calling thread; returns the
        ladder and the milliseconds it took. (A ModelServer warms up on
        its runner threads instead.)"""
        t0 = time.perf_counter()
        for b in self.buckets:
            self.run(self.host_batch(b), 0)
        return {"buckets": list(self.buckets),
                "ms": (time.perf_counter() - t0) * 1e3}

    def __repr__(self):
        return (f"ServedModel({self.name!r}, example={self.example_shape}, "
                f"dtype={self.dtype}, device={self.device}, "
                f"buckets={self.buckets})")

    @classmethod
    def from_block(cls, name, block, example_shape, dtype="float32",
                   buckets=None, ctx=None):
        """Serve a gluon Block whose parameters are initialized (run one
        forward first if their shapes were deferred). The parameters are
        copied onto ``ctx`` (default: the current context, the card)
        now."""
        device = (ctx or current_context()).torch_device()
        params = block.collect_params()
        snapshot = {}
        for pname, p in params.items():
            if p._data is None:
                raise ValueError(
                    f"model {name!r}: parameter {pname!r} not initialized; "
                    "run one forward pass (or initialize with explicit "
                    "shapes) first")
            snapshot[p] = NDArray(p.data()._data.detach().to(device,
                                                             copy=True))

        def fwd(x):
            with substitute(snapshot):
                out = block(NDArray(x))
            outs = out if isinstance(out, (tuple, list)) else (out,)
            return tuple(o._data for o in outs)

        return cls(name, fwd, example_shape, dtype, buckets, device)


class ModelContainer:
    """An ordered, named set of :class:`ServedModel` s."""

    def __init__(self, models=None):
        self._models = OrderedDict()
        for m in models or ():
            self.add(m)

    def add(self, model: ServedModel) -> ServedModel:
        if model.name in self._models:
            raise ValueError(f"model {model.name!r} already in container")
        self._models[model.name] = model
        return model

    def add_block(self, name, block, example_shape, **kw):
        return self.add(ServedModel.from_block(name, block, example_shape,
                                               **kw))

    def names(self):
        return list(self._models)

    def get(self, name) -> ServedModel:
        m = self._models.get(name)
        if m is None:
            raise ModelNotFound(f"model {name!r} not in container; "
                                f"available: {sorted(self._models)}")
        return m

    def __getitem__(self, name):
        return self.get(name)

    def __contains__(self, name):
        return name in self._models

    def __iter__(self):
        return iter(self._models.values())

    def __len__(self):
        return len(self._models)
