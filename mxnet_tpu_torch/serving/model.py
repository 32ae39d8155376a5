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

Live weight swaps (JAX :160-250; the model bus's subscriber calls
:meth:`ServedModel.swap_params`). The JAX swap rebinds a tuple of new
device buffers, which XLA accepts as they have the same avals. Here the
bucket graphs read the snapshot tensors by address, so a swap writes the
new values into those same tensors and nothing is captured again:

1. staging, off the run path: the new host arrays are copied into a
   pinned host set and from there, on a side stream of their own, into a
   second device set (both made at the first swap, with the snapshot's
   shapes and dtypes), and the watcher thread waits for that copy;
2. the flip, between batches: under the lock that every batch holds
   while it runs (:meth:`run_versioned`) and ``compile._capture_lock``
   (no capture reads the snapshot meanwhile), the replay stream, the
   one every batch of the model runs on (:attr:`replay_stream`), copies
   the staged set into the snapshot (``torch._foreach_copy_``,
   device to device) and ``(version, swaps)`` moves on.

A swap holds a lock of its own from its checks to its flip, so two
callers (the bus watcher and a direct call) never stage into the shared
sets at once. A batch that started before the flip ran wholly on the old
values and is stamped with the old version; the next batch is ordered
after the copy on the same stream and runs wholly on the new ones. On
the CPU the flip copies the host arrays in under the same locks.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict

import numpy as _np
import torch

from .. import autograd
from .. import compile as _compile
from ..base import MXNetError, canonical_dtype, dtype_name, numpy_dtype
from ..context import current_context
from ..gluon.parameter import substitute
from ..ndarray import NDArray
from . import config as _config
from .config import coerce
from .errors import ModelNotFound

__all__ = ["ServedModel", "ModelContainer"]


class ServedModel:
    """One inference model: a forward on ``device``, its input row shape
    and dtype, its padded-bucket ladder, and the snapshot of weights it
    reads, swapped in place by :meth:`swap_params`."""

    def __init__(self, name, forward, example_shape, dtype="float32",
                 buckets=None, device=None, weight_dtype=None, reads=(),
                 aux_reads=(), param_names=None, aux_names=None):
        """``forward(tensor) -> tuple of tensors``; ``reads`` and
        ``aux_reads``: the parameter and auxiliary-state tensors it reads
        beside its input (the loaders' snapshot, named by ``param_names``
        and ``aux_names`` where the loader knows them), whose data
        pointers each bucket's entry holds."""
        self.name = str(name)
        self.example_shape = tuple(int(s) for s in example_shape)
        self.dtype = dtype_name(dtype)
        self.weight_dtype = dtype_name(weight_dtype or dtype)
        self.buckets = coerce("buckets", buckets or
                              _config.effective()["buckets"])
        self.device = device if device is not None else \
            current_context().torch_device()
        self._praws = tuple(reads)
        self._araws = tuple(aux_reads)
        held = self._praws + self._araws
        self._fwd = _compile.jit(
            forward, site="serving",
            token=("serving", self.name, self.example_shape, self.dtype,
                   self.weight_dtype, id(self)),
            reads=lambda: held)
        # the model-bus census surface and the version behind live swaps
        self.param_names = list(param_names) if param_names else None
        self.aux_names = list(aux_names) if aux_names else None
        self._version = 0
        self._swaps = 0
        # held by every batch while it runs and by every flip
        self._run_lock = threading.Lock()
        # held by a swap from its checks to its flip: the staging sets
        # are shared, so one swap stages and flips before the next
        # stages (lock order: swap, run, capture)
        self._swap_lock = threading.Lock()
        on_card = self.device.type == "cuda"
        # the stream every batch runs on, and every flip's copy
        self._replay = torch.cuda.Stream(self.device) if on_card else None
        self._h2d = None  # side stream for request batches to the card
        self._swap_stream = None  # side stream for staged weights
        self._staging = None  # (pinned host set, device set), first swap
        self._flipped = None  # event: the last flip's copy is done

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

    @property
    def replay_stream(self):
        """The CUDA stream every batch of this model runs on and every
        flip copies on (None on the CPU)."""
        return self._replay

    def run(self, x, rows=None, ready=None):
        """Run the forward on a (padded) batch and return the outputs as
        host numpy arrays sliced to ``rows``. ``x`` is a host array or a
        device tensor from :meth:`stage` with its ``ready`` event. On a
        card the replay stream waits for that event, copies ``x`` into
        the bucket's static input and replays the bucket's graph (the
        first batch of a bucket captures it). Waits for the device (the
        copy to host)."""
        return self.run_versioned(x, rows, ready)[0]

    def run_versioned(self, x, rows=None, ready=None):
        """:meth:`run`, and the version of the weights the batch ran on,
        read once under the lock that a flip takes: the whole batch ran
        on that version's values."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(_np.asarray(x))
        n = x.shape[0] if rows is None else rows
        with self._run_lock, _on(self._replay):
            version = self._version
            x = x.to(self.device)
            if ready is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                x.record_stream(stream)
            with torch.inference_mode(), autograd.pause(train_mode=False):
                outs = self._fwd(x)
            host = [o[:n].to("cpu", dtype=canonical_dtype(
                numpy_dtype(o.dtype))).numpy() for o in outs]
        return host, version

    # ------------------------------------------------------- live swaps ---
    @property
    def version(self):
        """The model-bus version of the served weights (0: the load-time
        weights, never swapped)."""
        return self._version

    @property
    def swaps(self):
        """How many times :meth:`swap_params` flipped the weights."""
        return self._swaps

    def pinned(self):
        """``(param tensors, aux tensors, version)``: the snapshot the
        batches read (written in place by each flip) and its version."""
        return self._praws, self._araws, self._version

    def census(self):
        """Per-tensor ``{name, shape, dtype}`` lists: the shape and dtype
        contract a bus record must match to be applied here."""
        def ents(raws, names):
            return [{"name": names[i] if names else None,
                     "shape": list(r.shape), "dtype": _dtype_str(r)}
                    for i, r in enumerate(raws)]
        return {"params": ents(self._praws, self.param_names),
                "aux": ents(self._araws, self.aux_names)}

    def swap_params(self, raws, version, aux_raws=None):
        """Flip the served weights to ``raws`` (host arrays or tensors in
        parameter order; ``aux_raws`` likewise, else the aux state
        stays), stamping ``version``.

        Shapes and dtypes must match :meth:`census`, else ValueError (the
        bus then quarantines the version). The values are staged off the
        run path and copied into the snapshot between two batches (see
        the module's docstring), so every bucket graph stays valid:
        nothing is captured again. Returns :meth:`pinned`."""
        with self._swap_lock:
            news = self._checked(raws, self._praws, "param")
            targets = self._praws
            if aux_raws is not None:
                news += self._checked(aux_raws, self._araws, "aux")
                targets += self._araws
            staged = self._stage_swap(news)
            with self._run_lock, _compile._capture_lock:
                self._flip(staged, targets, int(version))
        return self.pinned()

    def _checked(self, news, curs, kind):
        news = list(news)
        if len(news) != len(curs):
            raise ValueError(
                f"model {self.name!r}: swap_params got {len(news)} "
                f"{kind} arrays, serving {len(curs)}")
        out = []
        for i, (new, cur) in enumerate(zip(news, curs)):
            a = new.detach() if isinstance(new, torch.Tensor) else \
                _np.asarray(new)
            if tuple(a.shape) != tuple(cur.shape) or \
                    _dtype_str(a) != _dtype_str(cur):
                raise ValueError(
                    f"model {self.name!r}: swap_params {kind}[{i}] is "
                    f"{tuple(a.shape)}/{_dtype_str(a)}, serving "
                    f"{tuple(cur.shape)}/{_dtype_str(cur)} -- the bus "
                    "census must match (shape-changing updates need a "
                    "rollout)")
            out.append(a)
        return out

    def _stage_swap(self, news):
        """The new values where the flip copies them from: on the CPU,
        host tensors; on a card, the device staging set, filled through
        the pinned host set on the swap stream, with the event that ends
        that copy (waited for here)."""
        if self._replay is None:
            return [_host_tensor(a) for a in news], None
        side = self._swap_stream
        if self._staging is None:
            every = self._praws + self._araws
            self._staging = (
                [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in every],
                [torch.empty_like(t) for t in every])
            side = self._swap_stream = torch.cuda.Stream(self.device)
            side.wait_stream(self._replay)
            with torch.cuda.stream(side):
                # the first flip must not load its copy kernel while it
                # holds the batch lock: the same copy, snapshot to
                # staging set, runs once here
                torch._foreach_copy_(self._staging[1], list(every))
        host, dev = self._staging
        on_card = [isinstance(a, torch.Tensor) and a.device.type == "cuda"
                   for a in news]
        if any(on_card):
            # values the caller made on the card: after the caller's work
            side.wait_stream(torch.cuda.current_stream(self.device))
        srcs = []
        for h, a, card in zip(host, news, on_card):
            if card:
                a.record_stream(side)
                srcs.append(a)
            else:
                srcs.append(h.copy_(_host_tensor(a)))
        n = len(news)
        with torch.cuda.stream(side):
            if self._flipped is not None:  # the last flip read the set
                side.wait_event(self._flipped)
            torch._foreach_copy_(dev[:n], srcs, non_blocking=True)
            staged = torch.cuda.Event()
            staged.record(side)
        staged.synchronize()  # the pinned set is free for the next swap
        return dev[:n], staged

    def _flip(self, staged, targets, version):
        """Copy the staged values into the snapshot on the replay stream
        and move the version on; the caller holds the run lock and
        ``compile._capture_lock``."""
        values, ready = staged
        with torch.no_grad(), _on(self._replay):
            if ready is not None:
                self._replay.wait_event(ready)
            torch._foreach_copy_(list(targets), list(values))
            if self._replay is not None:
                self._flipped = torch.cuda.Event()
                self._flipped.record(self._replay)
        self._version = version
        self._swaps += 1

    def _host_values(self):
        """Host copies of the parameter tensors as the batches read them
        (a sparse bus record's base)."""
        with self._run_lock, _on(self._replay):
            return [t.detach().to("cpu", dtype=canonical_dtype(
                numpy_dtype(t.dtype))).numpy() for t in self._praws]

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
                   _weight_dtype(tensors, dtype), reads=tensors,
                   param_names=list(params))

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
                   reads=list(args.values()), aux_reads=list(auxs.values()),
                   param_names=pnames, aux_names=list(aux_names))

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

    @classmethod
    def from_onnx(cls, name, model_file, example_shape, dtype="float32",
                  buckets=None, input_name=None, ctx=None):
        """Not ported: raises MXNetError (the ONNX importer is not in
        mxnet_tpu_torch)."""
        raise MXNetError("ServedModel.from_onnx is not ported: the ONNX "
                         "importer is not in mxnet_tpu_torch")


@contextlib.contextmanager
def _on(stream):
    """Make ``stream`` current on this thread (nothing when None)."""
    if stream is None:
        yield
    else:
        with torch.cuda.stream(stream):
            yield


def _dtype_str(a):
    """A numpy array's or a tensor's dtype as its name (``"float32"``)."""
    return str(a.dtype).replace("torch.", "")


def _host_tensor(a):
    """A host array (or tensor) as a CPU tensor, sharing its memory where
    numpy allows it."""
    if isinstance(a, torch.Tensor):
        return a
    a = _np.asarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


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

    def add_onnx(self, name, model_file, example_shape, **kw):
        return self.add(ServedModel.from_onnx(name, model_file,
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
