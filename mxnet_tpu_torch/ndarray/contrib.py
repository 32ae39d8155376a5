"""``mx.nd.contrib``: the contrib ops without their prefix, control flow
and the float checks.

Counterpart of ``mxnet_tpu/ndarray/contrib.py`` (MXNet 1.x
``python/mxnet/ndarray/contrib.py``: ``foreach`` :70, ``while_loop``
:193, ``cond`` :332). Every op whose name or an alias starts with
``_contrib_`` is here without the prefix (``box_nms``, ``MultiBoxPrior``,
``fft``, ``ROIAlign``, ...). The JAX package compiles a loop into
``lax.scan`` and a branch into ``lax.cond`` when it is traced, and runs
them op by op on the tape when it records outside a trace. The port has
no tracer: it keys on the compile service (``compile.inside()``: the
body of a hybridized block, an executor's graph or a trainer's step, on
the card captured into a CUDA graph).

* ``foreach`` runs ``body`` once per slice of ``data``'s first axis, in
  Python, wherever it is called: the trip count is the data's shape, so
  the loop unrolls into a captured graph as it is.
* ``while_loop`` outside a compiled body and under ``autograd.record()``
  reads ``cond`` on the host before each step, as the JAX package's
  recording path does; anywhere else it runs the masked form of the JAX
  scan: ``max_iterations`` steps, each computing ``func`` and keeping its
  results only while every ``cond`` so far held, with no host read (so it
  captures). Either way the outputs are stacked to ``max_iterations``
  rows, zeros past the stop, and the loop variables are those of the
  last step that ran.
* ``cond`` outside a compiled body reads ``pred`` on the host and runs
  one branch. Inside one it runs both branches on the card and selects
  with ``torch.where``, with no host read. So that the untaken branch's
  backward cannot turn ``0 * inf`` into NaN (``sqrt`` of a negative
  number), every tensor that requires grad and enters a branch from
  outside passes through a gate whose backward keeps the gradient only
  where that branch was taken: the gradients are ``lax.cond``'s. Both
  branches run, so they must be free of side effects, as ``lax.cond``'s
  traced branches are, and valid for either value of ``pred``.
* ``isfinite``, ``isnan`` and ``isinf`` give 1/0 in the input's dtype.

Left out: the DGL graph functions (``dgl_csr_neighbor_uniform_sample``,
``dgl_csr_neighbor_non_uniform_sample``, ``dgl_subgraph``, ``edge_id``,
``dgl_adjacency``, ``dgl_graph_compact``) and ``getnnz`` work on CSR
arrays, which the port does not have yet; each raises
:class:`~mxnet_tpu_torch.base.MXNetError` (``ROADMAP.md`` item A4).
"""
from __future__ import annotations

import sys as _sys

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_map

from .. import autograd as _autograd
from .. import compile as _compile
from ..base import MXNetError
from ..ops import registry as _registry
from .ndarray import NDArray, array, stack, zeros_like

__all__ = ["foreach", "while_loop", "cond", "isfinite", "isnan", "isinf"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _nd(x):
    return x if isinstance(x, NDArray) else array(x)


def _stacked(cols, single):
    out = [stack(*col, axis=0) for col in cols]
    return out[0] if single else out


def foreach(body, data, init_states):
    """``body(data_slice, states) -> (outputs, new_states)`` over axis 0 of
    ``data`` (an array or a list); returns the outputs stacked over the
    steps and the final states."""
    data_list = [_nd(d) for d in _as_list(data)]
    data_single = not isinstance(data, (list, tuple))
    states_single = not isinstance(init_states, (list, tuple))
    states = [_nd(s) for s in _as_list(init_states)]
    cols, out_single = None, True
    for i in range(data_list[0].shape[0]):
        xs = [d[i] for d in data_list]
        outs, new_states = body(xs[0] if data_single else xs,
                                states[0] if states_single else states)
        if cols is None:
            out_single = not isinstance(outs, (list, tuple))
            cols = [[] for _ in _as_list(outs)]
        for col, o in zip(cols, _as_list(outs)):
            col.append(o)
        states = [_nd(s) for s in _as_list(new_states)]
    if cols is None:
        raise ValueError("foreach over an empty axis: no output structure")
    return _stacked(cols, out_single), \
        (states[0] if states_single else states)


def _call(fn, vs, single):
    return fn(vs[0]) if single else fn(*vs)


def while_loop(cond, func, loop_vars, max_iterations=None):
    """Run ``func(*loop_vars) -> (outputs, new_loop_vars)`` while
    ``cond(*loop_vars)`` holds, at most ``max_iterations`` times. Returns
    the outputs stacked to ``max_iterations`` rows (zeros past the last
    step) and the final loop variables."""
    if max_iterations is None:
        raise ValueError("max_iterations is required")
    single = not isinstance(loop_vars, (list, tuple))
    vs = [_nd(v) for v in _as_list(loop_vars)]
    cols, out_single = None, True
    if _autograd.is_recording() and not _compile.inside():
        steps = 0
        for _ in range(max_iterations):
            if not bool(_call(cond, vs, single).asscalar()):
                break
            outs, new_vs = _call(func, vs, single)
            if cols is None:
                out_single = not isinstance(outs, (list, tuple))
                cols = [[] for _ in _as_list(outs)]
            for col, o in zip(cols, _as_list(outs)):
                col.append(o)
            vs = [_nd(v) for v in _as_list(new_vs)]
            steps += 1
        if cols is None:
            raise ValueError("while_loop made zero iterations; cannot "
                             "infer output structure")
        for col in cols:
            col.extend(zeros_like(col[0]) for _ in range(max_iterations
                                                         - steps))
        return _stacked(cols, out_single), (vs[0] if single else vs)
    active = None
    for _ in range(max_iterations):
        pred = _call(cond, vs, single)._data.reshape(()).to(torch.bool)
        run = pred if active is None else active & pred
        outs, new_vs = _call(func, vs, single)
        if cols is None:
            out_single = not isinstance(outs, (list, tuple))
            cols = [[] for _ in _as_list(outs)]
        for col, o in zip(cols, _as_list(outs)):
            o = o._data
            col.append(NDArray(torch.where(run, o, torch.zeros_like(o))))
        vs = [NDArray(torch.where(run, _nd(n)._data, v._data))
              for n, v in zip(_as_list(new_vs), vs)]
        active = run
    return _stacked(cols, out_single), (vs[0] if single else vs)


class _Gate(torch.autograd.Function):
    """The identity, whose backward keeps the gradient only where
    ``take`` (a 0-d bool on the device) holds."""

    @staticmethod
    def forward(ctx, x, take):
        ctx.save_for_backward(take)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        (take,) = ctx.saved_tensors
        return torch.where(take, grad, torch.zeros_like(grad)), None


class _GatedBranch(TorchFunctionMode):
    """While a branch runs: each tensor that requires grad and was not
    made inside the branch enters every torch call through one
    :class:`_Gate` keyed on whether the branch was taken."""

    def __init__(self, take):
        super().__init__()
        self._take = take
        self._made = {}     # id -> tensor made inside the branch
        self._gated = {}    # id -> (outside tensor, its gated view)

    def _gate(self, x):
        if not isinstance(x, torch.Tensor) or not x.requires_grad or \
                id(x) in self._made:
            return x
        if id(x) not in self._gated:
            self._gated[id(x)] = (x, _Gate.apply(x, self._take))
        return self._gated[id(x)][1]

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args, kwargs = tree_map(self._gate, (args, kwargs or {}))
        out = func(*args, **kwargs)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._made[id(t)] = t
        return out


def _branch(fn, take):
    with _GatedBranch(take):
        outs = fn()
    return outs


def cond(pred, then_func, else_func):
    """``then_func()`` if ``pred`` else ``else_func()``; each returns an
    NDArray or a list of them, alike in shape and dtype."""
    if not isinstance(pred, NDArray):
        return then_func() if pred else else_func()
    if not _compile.inside():
        return then_func() if bool(pred.asscalar()) else else_func()
    take = pred._data.reshape(()).to(torch.bool)
    then_outs = _branch(then_func, take)
    else_outs = _branch(else_func, ~take)
    picked = [NDArray(torch.where(take, t._data, e._data)) for t, e in
              zip(_as_list(then_outs), _as_list(else_outs))]
    return picked if isinstance(then_outs, (list, tuple)) else picked[0]


def isfinite(data):
    return NDArray(torch.isfinite(data._data).to(data._data.dtype))


def isnan(data):
    return NDArray(torch.isnan(data._data).to(data._data.dtype))


def isinf(data):
    return NDArray(torch.isinf(data._data).to(data._data.dtype))


def _waiting(name):
    def fn(*args, **kwargs):
        raise MXNetError(
            f"nd.contrib.{name} is not ported: it works on CSR sparse "
            "arrays, which come with the port's sparse arrays (ROADMAP.md, "
            "item A4)")

    fn.__name__ = fn.__qualname__ = name
    return fn


for _name in ("dgl_csr_neighbor_uniform_sample",
              "dgl_csr_neighbor_non_uniform_sample", "dgl_subgraph",
              "edge_id", "dgl_adjacency", "dgl_graph_compact", "getnnz"):
    setattr(_sys.modules[__name__], _name, _waiting(_name))


def _expose(module, make_wrapper):
    """Put every op whose name or an alias starts with ``_contrib_`` on
    ``module`` without the prefix (the canonical name first)."""
    for name in _registry.list_ops():
        for cand in (name,) + _registry.aliases(name):
            if cand.startswith("_contrib_"):
                short = cand[len("_contrib_"):]
                if not hasattr(module, short):
                    setattr(module, short, make_wrapper(name, short))


def _expose_ops():
    from . import _make_wrapper

    _expose(_sys.modules[__name__], _make_wrapper)


_expose_ops()
