"""CachedOp: the captured-forward unit behind ``hybridize()``, and the
write-back of stateful buffers.

Counterpart of ``mxnet_tpu/cached_op.py``. The JAX ``CachedOp``
(:123-318) traces a block's forward once per input signature into one
compiled executable. Here its inference calls go through
:func:`mxnet_tpu_torch.compile.jit` under the site ``"cachedop"``: on a
CUDA card one CUDA graph per signature, captured once and replayed; on
the CPU a plain call with the same keys and statistics.

* **Arguments and outputs** keep their structure, as in the JAX package
  (:90-121): each NDArray, possibly in nested lists, tuples and dicts,
  is handed to ``compile.jit`` as its tensor, and ``jit``'s own pytree
  makes the key (other leaves are static and reach the forward as they
  are). Outputs come back as fresh NDArrays, copied out of the graph's
  static outputs.
* **Parameters** are read through their handles at call time
  (``Parameter.data()``, which honours ``gluon.parameter.substitute``).
  The entry of an input signature holds their data pointers: a
  rebinding (``set_data``, ``cast``, BatchNorm's running statistics
  after a training forward) replaces it with a new capture, an in-place
  write (an optimizer step) is seen by the next replay.
* **Eager in this slice:** calls under ``autograd.record()`` and calls in
  training mode run the forward eagerly (children included), so
  gradients flow through PyTorch's autograd as in an unhybridized block.
  Capturing them needs the backward as a second graph, BatchNorm's
  running statistics written in place and the per-device generator
  registered with the graph: the training slice.
* **Nested:** inside an outer capture (a served model's bucket, a
  hybridized parent), the forward runs plainly into the outer graph.

``update_state`` (JAX :77-86) is the one piece the training path needs:
BatchNorm's running statistics are ``grad_req="null"`` parameters that a
training forward rewrites. The port rebinds the handle, outside the
autograd graph. ``ShardedTrainer`` keeps the values from before the step
and selects them back when its non-finite guard skips the step.
"""
from __future__ import annotations

import torch

from . import autograd
from . import compile as _compile

__all__ = ["CachedOp", "update_state"]


def update_state(handle, new_value):
    """Rebind ``handle`` (a parameter's NDArray) to ``new_value``
    (an NDArray or a tensor), detached from any autograd graph."""
    new_raw = new_value._data if hasattr(new_value, "_data") else new_value
    handle._rebind(new_raw.detach())


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
    exactly what a HybridBlock's forward does."""

    def __init__(self, forward_fn, params=None):
        self._fn = forward_fn
        self._params = list(params or [])
        self._site = "CachedOp[%s]" % getattr(
            forward_fn, "__qualname__", type(forward_fn).__name__)
        self._jit = _compile.jit(self._run, site="cachedop",
                                 token=(self._site, id(self)),
                                 reads=self._param_tensors)

    def _param_tensors(self):
        return [p.data()._data for p in self._params]

    def _run(self, *raws):
        """The captured body: the forward on NDArrays around ``raws``,
        its outputs as tensors."""
        from .ndarray import NDArray

        return _map(self._fn(*_map(raws, NDArray, torch.Tensor)), _raw,
                    NDArray)

    def __call__(self, *args):
        from .ndarray import NDArray

        if autograd.is_recording() or autograd.is_training():
            with _compile.nested():
                return self._fn(*args)
        return _map(self._jit(*_map(args, _raw, NDArray)), NDArray,
                    torch.Tensor)

    def stats(self):
        """This op's capture statistics (``ServiceFunction.stats``)."""
        return self._jit.stats()
