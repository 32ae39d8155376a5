"""ServedModel / ModelContainer: models served at a ladder of padded
batch buckets.

Counterpart of ``mxnet_tpu/serving/model.py``. A :class:`ServedModel`
wraps one inference forward ``fwd(tensor) -> tensor(s)`` on one device
(the card unless ``ctx=mx.cpu()``). The loaders copy the parameters
onto the device at build time, so later changes to the live parameters
do not leak into serving:

* :meth:`ServedModel.from_block`: a gluon Block, run on its snapshot
  through :func:`~mxnet_tpu_torch.gluon.parameter.substitute`;
* :meth:`ServedModel.from_symbol` (:331): a Symbol and its parameter
  dicts, run by the graph's evaluator (``Symbol._build_eval``);
* :meth:`ServedModel.from_checkpoint` (:381): a ``save_checkpoint`` pair.

A quantized model (``contrib.quantization``) loads through the same
loaders: its int8 weight parameters are detected, and ``weight_dtype``
(:78-88) says ``"int8"`` where a float model says its float dtype; the
input dtype stays float.

Requests carry a leading batch dim ``(k,) + example_shape``; the batcher
coalesces rows into the smallest bucket that holds them. The smallest
default bucket is 2, as in the JAX package.

Each bucket's forward goes through :func:`mxnet_tpu_torch.compile.jit`
under the site ``"serving"`` (JAX :70-118): on a card, one CUDA graph per
bucket, captured at its first batch (:meth:`ServedModel.warmup` captures
them all) and replayed for every batch after, the whole block or graph
(its 74 int8 GEMMs and 12 flash launches included) in one launch; on the
CPU a plain call with the same keys and statistics. The key holds the
snapshot's data pointers, so a model keeps one graph per bucket. Only
``compile.set_enabled(False)`` runs a bucket eagerly on the card; a
capture that fails raises (``compile.CaptureError``).
"""
from __future__ import annotations

import time
from collections import OrderedDict

import numpy as _np
import torch

from .. import autograd
from .. import compile as _compile
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
                 buckets=None, device=None, weight_dtype=None, reads=()):
        """``forward(tensor) -> tuple of tensors``; ``reads``: the tensors
        it reads beside its input (the loaders' snapshot), whose data
        pointers each bucket's entry holds."""
        self.name = str(name)
        self.example_shape = tuple(int(s) for s in example_shape)
        self.dtype = dtype_name(dtype)
        self.weight_dtype = dtype_name(weight_dtype or dtype)
        self.buckets = coerce("buckets", buckets or DEFAULTS["buckets"])
        self.device = device if device is not None else \
            current_context().torch_device()
        reads = tuple(reads)
        self._fwd = _compile.jit(
            forward, site="serving",
            token=("serving", self.name, self.example_shape, self.dtype,
                   self.weight_dtype, id(self)),
            reads=lambda: reads)
        self._h2d = None  # side stream for host-to-device copies

    @property
    def quantized(self):
        """True for an int8-weight (quantized) model."""
        return self.weight_dtype == "int8"

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
        device tensor from :meth:`stage` with its ``ready`` event. On a
        card the current stream waits for that event, copies ``x`` into
        the bucket's static input and replays the bucket's graph (the
        first batch of a bucket captures it). Waits for the device (the
        copy to host)."""
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
        """Run every bucket once on the calling thread, which captures
        each bucket's graph on a card; returns the ladder and the
        milliseconds it took. After it, traffic captures nothing
        (``compile.stats()["serving"]["misses"]`` stays). (A ModelServer
        warms up on its runner threads instead.)"""
        t0 = time.perf_counter()
        for b in self.buckets:
            self.run(self.host_batch(b), 0)
        return {"buckets": list(self.buckets),
                "ms": (time.perf_counter() - t0) * 1e3}

    def capture_stats(self):
        """This model's captures: ``{captures, capture_ms, hits, misses,
        replays, ...}`` and ``capture_ms_by_bucket`` (host ms to build each
        bucket's entry: on a card its eager first call and capture)."""
        st = self._fwd.stats()
        by_bucket = {e["shapes"][0][0]: e["ms"] for e in st.pop("entries")
                     if e["shapes"]}
        return dict(st, capture_ms_by_bucket=by_bucket)

    def __repr__(self):
        return (f"ServedModel({self.name!r}, example={self.example_shape}, "
                f"dtype={self.dtype}, weight_dtype={self.weight_dtype}, "
                f"device={self.device}, buckets={self.buckets})")

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

        tensors = [a._data for a in snapshot.values()]
        return cls(name, fwd, example_shape, dtype, buckets, device,
                   _weight_dtype(tensors, dtype), reads=tensors)

    @classmethod
    def from_symbol(cls, name, sym, arg_params=None, aux_params=None,
                    input_name=None, example_shape=None, dtype="float32",
                    buckets=None, ctx=None):
        """Serve a Symbol and its ``{name: NDArray}`` (or numpy)
        parameter dicts; the data input is the one argument without a
        value unless ``input_name`` says. The parameters are copied onto
        ``ctx`` (default: the current context, the card) now."""
        if example_shape is None:
            raise ValueError("from_symbol requires example_shape (the "
                             "per-row input shape, without the batch dim)")
        device = (ctx or current_context()).torch_device()
        arg_params = dict(arg_params or {})
        aux_params = dict(aux_params or {})
        arg_names = sym.list_arguments()
        aux_names = sym.list_auxiliary_states()
        if input_name is None:
            data_names = [n for n in arg_names if n not in arg_params]
            if len(data_names) != 1:
                raise ValueError(
                    f"model {name!r}: cannot infer the data input from "
                    f"{data_names or arg_names}; pass input_name=")
            input_name = data_names[0]
        elif input_name not in arg_names:
            raise ValueError(f"model {name!r}: {input_name!r} is not an "
                             f"argument of the symbol ({arg_names})")
        pnames = [n for n in arg_names if n != input_name]
        missing = [n for n in pnames if n not in arg_params] + \
                  [n for n in aux_names if n not in aux_params]
        if missing:
            raise ValueError(
                f"model {name!r}: no parameter values for {missing}")

        def snap(v):
            t = v._data if isinstance(v, NDArray) else \
                torch.as_tensor(_np.asarray(v))
            return t.detach().to(device, copy=True)

        args = {n: snap(arg_params[n]) for n in pnames}
        auxs = {n: snap(aux_params[n]) for n in aux_names}
        run = sym._build_eval()

        def fwd(x):
            return tuple(run(dict(args, **{input_name: x}), auxs))

        return cls(name, fwd, example_shape, dtype, buckets, device,
                   _weight_dtype(args.values(), dtype),
                   reads=list(args.values()) + list(auxs.values()))

    @classmethod
    def from_checkpoint(cls, name, prefix, epoch, example_shape,
                        dtype="float32", buckets=None, input_name=None,
                        ctx=None):
        """Serve a ``save_checkpoint`` pair (``prefix-symbol.json`` and
        ``prefix-%04d.params``), read to the host and copied onto
        ``ctx``."""
        from ..context import cpu
        from ..model import load_checkpoint

        sym, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                      ctx=cpu())
        return cls.from_symbol(name, sym, arg_params, aux_params,
                               input_name=input_name,
                               example_shape=example_shape, dtype=dtype,
                               buckets=buckets, ctx=ctx)


def _weight_dtype(tensors, dtype):
    """``"int8"`` when any parameter is int8 (a quantized model), else
    the model's input dtype."""
    return "int8" if any(t.dtype == torch.int8 for t in tensors) else dtype


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

    def add_symbol(self, name, sym, arg_params=None, aux_params=None, **kw):
        return self.add(ServedModel.from_symbol(name, sym, arg_params,
                                                aux_params, **kw))

    def add_checkpoint(self, name, prefix, epoch, example_shape, **kw):
        return self.add(ServedModel.from_checkpoint(name, prefix, epoch,
                                                    example_shape, **kw))

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
