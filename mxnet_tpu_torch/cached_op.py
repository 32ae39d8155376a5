"""CachedOp: the captured unit behind ``hybridize()``, and the in-place
write-back of stateful buffers.

Counterpart of ``mxnet_tpu/cached_op.py``. The JAX ``CachedOp``
(:123-318) traces a block's forward once per input signature into one
compiled executable, and under ``autograd.record()`` its forward and
backward (:166-226, :282-318). Here every call goes through
:func:`mxnet_tpu_torch.compile.jit` under the site ``"cachedop"``: on a
CUDA card CUDA graphs, captured once per signature and replayed; on the
CPU a plain call with the same keys and statistics.

* **Inference calls** (not recording, not in training mode): one
  ``"forward"`` entry per signature, a graph whose replay returns fresh
  copies of its outputs.
* **Recording and training-mode calls**: one ``"pair"`` entry per
  signature and mode (recording, training): the forward graph and the
  backward graph on one pool, replayed by one ``autograd.Function``
  whose inputs are the arguments and the parameters' gradient leaves
  (``Parameter.data()`` under ``record()``). So ``backward`` writes each
  parameter's gradient buffer by its ``grad_req`` and marks it fresh,
  exactly as for an unhybridized block (``autograd.backward``). A
  training forward's BatchNorm statistics are written in place in the
  graph (:func:`update_state`) and Dropout draws from the registered
  generator, anew at each replay.
* **Arguments and outputs** keep their structure, as in the JAX package
  (:90-121): each NDArray, possibly in nested lists, tuples and dicts,
  is handed to ``compile.jit`` as its tensor, and ``jit``'s own pytree
  makes the key (other leaves are static and reach the forward as they
  are). Outputs come back as fresh NDArrays.
* **Parameters** are read through their handles at call time
  (``Parameter.data()``, which honours ``gluon.parameter.substitute``).
  An entry holds their data pointers: a rebinding (``set_data``,
  ``cast``) replaces it with a new capture, an in-place write (an
  optimizer step, the running statistics) is seen by the next replay.
* **Nested:** inside an outer capture (a served model's bucket, a
  hybridized parent, a trainer's step), the forward runs plainly into
  the outer graph.

``update_state`` (JAX :77-86): BatchNorm's running statistics are
``grad_req="null"`` parameters that a training forward rewrites. The
port writes the new values into the handle's tensor in place (so the
tensor keeps its storage, which a graph reads and writes), outside the
autograd graph; only a value of another shape or dtype rebinds the
handle. ``ShardedTrainer`` copies the values from before the step and
selects them back when its non-finite guard skips the step.
"""
from __future__ import annotations

import torch

from . import autograd
from . import compile as _compile
from .base import MXNetError

__all__ = ["CachedOp", "update_state"]


def update_state(handle, new_value):
    """Write ``new_value`` (an NDArray or a tensor) into ``handle`` (a
    parameter's NDArray) in place, detached from any autograd graph; a
    value of another shape or dtype rebinds the handle instead. Nothing
    is written while a checkpointed forward is recomputed
    (``autograd.is_recomputing``): its first run wrote it."""
    if autograd.is_recomputing():
        return
    new_raw = new_value._data if hasattr(new_value, "_data") else new_value
    old = handle._data
    if old.shape != new_raw.shape or old.dtype != new_raw.dtype:
        handle._rebind(new_raw.detach())
    elif old is not new_raw:
        with torch.no_grad():
            old.copy_(new_raw)


def _map(obj, fn, kind):
    """``obj`` with each leaf of type ``kind`` replaced by ``fn(leaf)``,
    through tuples, lists and dicts (``compile.jit``'s structure)."""
    t = type(obj)
    if t is tuple or t is list:
        return t(_map(o, fn, kind) for o in obj)
    if t is dict:
        return {k: _map(v, fn, kind) for k, v in obj.items()}
    return fn(obj) if isinstance(obj, kind) else obj


def _raw(a):
    return a._data


class CachedOp:
    """Capture-and-cache wrapper around an imperative forward function.

    ``forward_fn(*args)`` is a function of NDArrays (nested lists ok)
    that reads the Parameters in ``params`` through ``Parameter.data()``,
    exactly what a HybridBlock's forward does. A bound method (the
    block's ``forward``) is held weakly, as ``compile.jit`` holds this
    op's own methods: the block owns its CachedOp, and dropping the block
    frees the op, its entries and their graph pools at once."""

    def __init__(self, forward_fn, params=None):
        self._fn_ref = _compile._weak(forward_fn)
        self._params = list(params or [])
        self._site = "CachedOp[%s]" % getattr(
            forward_fn, "__qualname__", type(forward_fn).__name__)
        self._jit = _compile.jit(self._run, site="cachedop",
                                 token=(self._site, id(self)),
                                 reads=self._param_tensors)
        self._pair = _compile.jit(self._run_mode, site="cachedop",
                                  token=(self._site, id(self), "pair"),
                                  reads=self._param_tensors, kind="pair")
        self._jit_np = None   # the entry of np-array calls, at first use

    def _param_tensors(self):
        return [p.data()._data for p in self._params]

    def _body(self, wrap, raws):
        """The captured body: the forward on arrays of class ``wrap``
        around ``raws``, its outputs as tensors."""
        from .ndarray import NDArray

        fn = self._fn_ref()
        if fn is None:
            raise MXNetError(f"{self._site}: the block whose forward this "
                             "op runs is gone")
        return _map(fn(*_map(raws, wrap, torch.Tensor)), _raw, NDArray)

    def _run(self, *raws):
        from .ndarray import NDArray

        return self._body(NDArray, raws)

    def _run_np(self, *raws):
        from .numpy import ndarray

        return self._body(ndarray, raws)

    def _run_mode(self, mode, *raws):
        """The pair's body; ``mode`` (recording, training, np) keys it."""
        if mode[2]:
            return self._run_np(*raws)
        return self._run(*raws)

    def __call__(self, *args):
        """Run the forward, captured. Fed an ``mx.np.ndarray`` it returns
        ``mx.np.ndarray`` (MXNet 1.x under ``use_np``; the JAX package
        returns NDArray, ROADMAP C34), from an entry of its own whose
        body sees np arrays, as the eager forward does."""
        from . import profiler as _profiler
        from .ndarray import NDArray

        prof_t0 = _profiler._now_us() if _profiler._REC_SYMBOLIC else None
        np_mode = any(getattr(a, "_np_frontend", False) for a in args)
        raws = _map(args, _raw, NDArray)
        recording, training = autograd.is_recording(), autograd.is_training()
        if recording or training:
            out = self._pair((recording, training, np_mode), *raws)
        elif np_mode:
            if self._jit_np is None:
                self._jit_np = _compile.jit(
                    self._run_np, site="cachedop",
                    token=(self._site, id(self), "np"),
                    reads=self._param_tensors)
            out = self._jit_np(*raws)
        else:
            out = self._jit(*raws)
        if np_mode:
            from .numpy import ndarray

            out = _map(out, ndarray, torch.Tensor)
        else:
            out = _map(out, NDArray, torch.Tensor)
        if prof_t0 is not None:
            _profiler.record_event("CachedOp", prof_t0,
                                   _profiler._now_us() - prof_t0,
                                   cat="symbolic")
        return out

    def stats(self):
        """This op's capture statistics (``ServiceFunction.stats``), the
        inference entries' and the pairs' together."""
        parts = [self._jit.stats(), self._pair.stats()]
        if self._jit_np is not None:
            parts.append(self._jit_np.stats())
        out = dict(parts[0])
        for p in parts[1:]:
            for k in out:
                out[k] = out[k] + p[k]
        return out
