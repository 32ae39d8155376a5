"""The ``Custom`` op: user-defined operators written in Python.

Counterpart of ``mxnet_tpu/ops/custom.py`` (MXNet 1.x
``src/operator/custom/custom.cc``). The user API is in
:mod:`mxnet_tpu_torch.operator` (``CustomOp``, ``CustomOpProp``,
``register``); this module holds the prop registry and the one op
``Custom`` that ``mx.nd.Custom(..., op_type=name)`` and ``mx.sym.Custom``
reach.

* **Signature.** The inputs are the prop's ``list_arguments()`` followed
  by its ``list_auxiliary_states()``; every other keyword goes to the
  prop's constructor. Output shapes and types come from the prop's
  ``infer_shape`` and ``infer_type``, and the operator from its
  ``create_operator(ctx, shapes, dtypes)``, once per signature (op type,
  keywords, input shapes, dtypes and device), then cached, as MXNet keeps
  one operator per node.
* **Calls.** The user's ``forward`` gets NDArrays on the inputs' device
  (outputs as zeros to ``assign`` into), runs with that device as the
  current context (``mx.nd.array(y)`` lands there), and gets
  ``is_train`` as
  ``autograd.is_training()``, or the executor's training flag in a
  Symbol graph; under ``autograd.record()`` the outputs hold one
  ``torch.autograd.Function`` node whose backward calls the user's
  ``backward`` with the output gradients, inputs and outputs, ``req``
  ``"write"`` for each input that takes a gradient and ``"null"`` for the
  others; auxiliary states take none. A prop made with
  ``need_top_grad=False`` is a loss head: its backward ignores the output
  gradient, so a ``backward()`` with no head gradients (the executor's
  ones) gives the same gradients as MXNet's.
* **The host.** The JAX op stages its callbacks into XLA with
  ``jax.pure_callback``; PyTorch has no such mechanism, and a body that
  calls ``asnumpy()`` syncs with the host, which a CUDA graph cannot
  hold. So ``Custom`` is a host op (``registry.register(host=True)``):
  the compile service runs a body that calls it uncaptured, a decision it
  makes from the body's first call, and counts those calls under the
  reason (``compile.stats()[site]["uncaptured"]``).
* **Shape inference** on ``meta`` tensors (the symbol layer's) runs the
  prop's inference alone, never the user's ``forward``.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .registry import register

# op_type -> CustomOpProp subclass (filled by mxnet_tpu_torch.operator)
CUSTOM_PROPS = {}
_lock = threading.Lock()
_ENTRIES = {}   # signature -> _Entry


def _make_prop(op_type, kwargs):
    try:
        cls = CUSTOM_PROPS[op_type]
    except KeyError:
        raise ValueError(
            f"custom op type {op_type!r} is not registered; decorate your "
            "CustomOpProp subclass with mx.operator.register("
            f"{op_type!r})") from None
    prop = cls(**kwargs)
    prop._kwargs = dict(kwargs)
    return prop


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple, set)):
        return tuple(_freeze(x) for x in v)
    return v


def _np_dtype(dtype):
    return np.dtype(str(dtype).replace("torch.", ""))


class _Entry:
    """One signature's prop, operator and output shapes and types."""

    def __init__(self, op_type, kwargs, arrays):
        from ..base import canonical_dtype
        from ..context import Context

        prop = _make_prop(op_type, kwargs)
        self.n_data = len(prop.list_arguments())
        self.n_out = len(prop.list_outputs())
        self.need_top_grad = prop.need_top_grad
        data = arrays[:self.n_data]
        in_shapes = [list(a.shape) for a in data]
        in_types = [_np_dtype(a.dtype) for a in data]
        _, out_shapes, _ = prop.infer_shape(in_shapes)
        self.out_shapes = [tuple(int(d) for d in s) for s in out_shapes]
        self.out_types = [canonical_dtype(np.dtype(t).name)
                          for t in prop.infer_type(in_types)[1]]
        dev = arrays[0].device if arrays else torch.device("cpu")
        self.ctx = None if dev.type == "meta" else Context.from_device(dev)
        self.op = None if self.ctx is None else prop.create_operator(
            self.ctx, in_shapes, in_types)


def _entry(op_type, kwargs, arrays):
    sig = (op_type, _freeze(kwargs),
           tuple((tuple(a.shape), a.dtype, a.device) for a in arrays))
    with _lock:
        e = _ENTRIES.get(sig)
    if e is None:
        e = _Entry(op_type, kwargs, arrays)
        with _lock:
            e = _ENTRIES.setdefault(sig, e)
    return e


def _nd(tensors):
    from ..ndarray import NDArray

    return [NDArray(t) for t in tensors]


class _CustomNode(torch.autograd.Function):
    """One ``Custom`` call: the user's forward in ``forward``, its
    backward in ``backward``."""

    @staticmethod
    def forward(ctx, e, is_train, *arrays):
        from .. import autograd

        with autograd.pause(train_mode=is_train), e.ctx:
            ins = _nd(arrays)
            outs = _nd(torch.zeros(s, dtype=t, device=arrays[0].device)
                       for s, t in zip(e.out_shapes, e.out_types))
            e.op.forward(is_train=is_train, req=["write"] * e.n_out,
                         in_data=ins[:e.n_data], out_data=outs,
                         aux=ins[e.n_data:])
        res = tuple(o._data for o in outs)
        ctx.e = e
        ctx.save_for_backward(*arrays, *res)
        return res

    @staticmethod
    def backward(ctx, *grads):
        from .. import autograd

        e = ctx.e
        saved = ctx.saved_tensors
        arrays, outs = saved[:-e.n_out], saved[-e.n_out:]
        needs = ctx.needs_input_grad[2:]
        with autograd.pause(), e.ctx:
            ins = _nd(arrays)
            in_grad = _nd(torch.zeros_like(a) for a in arrays[:e.n_data])
            e.op.backward(req=["write" if n else "null"
                               for n in needs[:e.n_data]],
                          out_grad=_nd(grads), in_data=ins[:e.n_data],
                          out_data=_nd(outs), in_grad=in_grad,
                          aux=ins[e.n_data:])
        return (None, None) + tuple(g._data for g in in_grad) + \
            (None,) * (len(arrays) - e.n_data)


def _node_prop(kwargs):
    kwargs = dict(kwargs)
    return _make_prop(kwargs.pop("op_type"), kwargs)


def _custom_num_outputs(n_inputs, kwargs):
    return len(_node_prop(kwargs).list_outputs())


def _custom_input_names(kwargs):
    prop = _node_prop(kwargs)
    return list(prop.list_arguments()), list(prop.list_auxiliary_states())


@register("Custom", num_outputs=_custom_num_outputs, host=True,
          input_names=_custom_input_names)
def custom(*arrays, op_type, training=None, **kwargs):
    """The registered operator ``op_type`` on ``arrays`` (its arguments,
    then its auxiliary states); ``kwargs`` go to its prop. ``training``,
    the symbol executor's flag, is ``is_train`` (else
    ``autograd.is_training()``)."""
    from .. import autograd

    e = _entry(op_type, kwargs, arrays)
    if arrays and arrays[0].device.type == "meta":
        outs = tuple(torch.empty(s, dtype=t, device="meta")
                     for s, t in zip(e.out_shapes, e.out_types))
    else:
        is_train = bool(autograd.is_training() if training is None
                        else training)
        outs = _CustomNode.apply(e, is_train, *arrays)
    return outs if e.n_out > 1 else outs[0]
