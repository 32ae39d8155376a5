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

* The DGL graph functions (``dgl_csr_neighbor_uniform_sample``,
  ``dgl_csr_neighbor_non_uniform_sample``, ``dgl_subgraph``, ``edge_id``,
  ``dgl_adjacency``, ``dgl_graph_compact``; JAX :262-507) are host numpy
  over a CSR array's parts, as the JAX functions, with their outputs on
  the graph's device. The samplers seed their numpy ``RandomState`` from
  ``mx.random``'s generator of that device, so they repeat under
  ``mx.random.seed``; the JAX package seeds from its threefry key, so the
  two packages draw different samples. ``getnnz`` is the op
  ``_contrib_getnnz``.
"""
from __future__ import annotations

import sys as _sys

import numpy as _np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_map

from .. import autograd as _autograd
from .. import compile as _compile
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


# ------------------------------------------------------------ DGL ops -----
# JAX ndarray/contrib.py:262-507 (MXNet 1.x src/operator/contrib/
# dgl_graph.cc): host work over the CSR parts, as there; the outputs go to
# the graph's device.

def _csr_parts(csr):
    return (csr.data.asnumpy(), csr.indices.asnumpy().astype(_np.int64),
            csr.indptr.asnumpy().astype(_np.int64))


def _dgl_sample_one(data, indices, indptr, seed, probability, num_hops,
                    num_neighbor, max_num_vertices, rng):
    """Breadth-first sampling from ``seed`` for ``num_hops`` hops, at
    most ``num_neighbor`` neighbours a vertex (uniform, or weighted by
    ``probability``), at most ``max_num_vertices`` vertices."""
    sampled = {}  # vertex -> layer
    edges = {}    # expanded vertex -> (sampled neighbour columns, values)
    frontier = []
    for v in (int(v) for v in seed if v >= 0):
        if v not in sampled and len(sampled) < max_num_vertices:
            sampled[v] = 0
            frontier.append(v)
    for hop in range(1, num_hops + 1):
        nxt = []
        for u in frontier:
            row = slice(indptr[u], indptr[u + 1])
            neigh, vals = indices[row], data[row]
            if len(neigh) == 0:
                edges[u] = ([], [])
                continue
            if probability is not None:
                pos = probability[neigh] > 0
                if int(pos.sum()) <= num_neighbor:
                    pick = _np.nonzero(pos)[0]
                else:
                    p = probability[neigh]
                    pick = rng.choice(len(neigh), num_neighbor,
                                      replace=False, p=p / p.sum())
            elif len(neigh) > num_neighbor:
                pick = rng.choice(len(neigh), num_neighbor, replace=False)
            else:
                pick = _np.arange(len(neigh))
            edges[u] = ([int(neigh[i]) for i in pick],
                        [vals[i] for i in pick])
            for i in pick:
                v = int(neigh[i])
                if v not in sampled:
                    if len(sampled) >= max_num_vertices:
                        break
                    sampled[v] = hop
                    nxt.append(v)
        frontier = nxt
    verts = _np.sort(_np.asarray(list(sampled), _np.int64))
    n = len(verts)
    # the sampled edges between sampled vertices, rows and columns local
    # positions into verts (the local -> global map)
    local = {int(v): i for i, v in enumerate(verts)}
    sub_ptr = _np.zeros(max_num_vertices + 1, _np.int64)
    sub_idx, sub_val = [], []
    for i, u in enumerate(verts):
        for col, val in zip(*edges.get(int(u), ([], []))):
            j = local.get(col)
            if j is not None:
                sub_idx.append(j)
                sub_val.append(val)
        sub_ptr[i + 1] = len(sub_idx)
    sub_ptr[n + 1:] = sub_ptr[n]
    out_verts = _np.full(max_num_vertices + 1, -1, _np.int64)
    out_verts[:n] = verts
    out_verts[-1] = n
    layer = _np.full(max_num_vertices, -1, _np.int64)
    layer[:n] = [sampled[int(v)] for v in verts]
    return out_verts, (sub_val, sub_idx, sub_ptr), layer


def _dgl_sample(csr, seeds, probability, num_hops, num_neighbor,
                max_num_vertices):
    from .. import random as _random
    from .sparse import csr_matrix

    data, indices, indptr = _csr_parts(csr)
    ctx = csr.context
    dev = ctx.torch_device()
    # the numpy stream's seed from mx.random's generator of the graph's
    # device: repeated under mx.random.seed (the JAX package draws it from
    # its threefry key, so the samples differ between the packages)
    rng = _np.random.RandomState(int(torch.randint(
        0, 2 ** 31 - 1, (1,), device=dev,
        generator=_random.generator(dev)).item()))
    vert_out, prob_out, csr_out, layer_out = [], [], [], []
    for s in seeds:
        verts, (sval, sidx, sptr), layer = _dgl_sample_one(
            data, indices, indptr, s.asnumpy().astype(_np.int64),
            probability, num_hops, num_neighbor, max_num_vertices, rng)
        vert_out.append(array(verts, ctx=ctx))
        if probability is not None:
            p = _np.zeros(max_num_vertices, _np.float32)
            nv = int(verts[-1])
            p[:nv] = probability[verts[:nv]]
            prob_out.append(array(p, ctx=ctx))
        csr_out.append(csr_matrix(
            (_np.asarray(sval, data.dtype), _np.asarray(sidx, _np.int64),
             sptr), shape=(max_num_vertices, max_num_vertices), ctx=ctx))
        layer_out.append(array(layer, ctx=ctx))
    return vert_out + prob_out + csr_out + layer_out


def dgl_csr_neighbor_uniform_sample(csr, *seeds, num_args=None, num_hops=1,
                                    num_neighbor=2, max_num_vertices=100):
    """Uniform neighbour sampling over a CSR graph. For each seed array:
    the sampled vertex ids (``max_num_vertices + 1`` long, the count in
    the last slot), then the sampled sub-CSRs (the original edge values),
    then each vertex's hop."""
    return _dgl_sample(csr, seeds, None, num_hops, num_neighbor,
                       max_num_vertices)


def dgl_csr_neighbor_non_uniform_sample(csr, probability, *seeds,
                                        num_args=None, num_hops=1,
                                        num_neighbor=2,
                                        max_num_vertices=100):
    """Neighbour sampling weighted by ``probability``; the sampled
    vertices' probabilities come as a second set of outputs."""
    p = probability.asnumpy().astype(_np.float64)
    return _dgl_sample(csr, seeds, p, num_hops, num_neighbor,
                       max_num_vertices)


def dgl_subgraph(graph, *vids, return_mapping=False, num_args=None):
    """The subgraph each vertex array induces, a CSR of ones; with
    ``return_mapping`` also a CSR of the original edge values."""
    from .sparse import csr_matrix

    data, indices, indptr = _csr_parts(graph)
    ctx = graph.context
    subs, maps = [], []
    for vid_arr in vids:
        verts = vid_arr.asnumpy().astype(_np.int64)
        local = {int(v): i for i, v in enumerate(verts)}
        n = len(verts)
        sptr = _np.zeros(n + 1, _np.int64)
        sidx, smap = [], []
        for i, u in enumerate(verts):
            for pos in range(indptr[u], indptr[u + 1]):
                j = local.get(int(indices[pos]))
                if j is not None:
                    sidx.append(j)
                    smap.append(data[pos])
            sptr[i + 1] = len(sidx)
        sidx = _np.asarray(sidx, _np.int64)
        subs.append(csr_matrix((_np.ones(len(sidx), _np.int64), sidx, sptr),
                               shape=(n, n), ctx=ctx))
        if return_mapping:
            maps.append(csr_matrix(
                (_np.asarray(smap, data.dtype), sidx, sptr.copy()),
                shape=(n, n), ctx=ctx))
    return subs + maps


def edge_id(csr, u, v):
    """The stored value at ``(u[i], v[i])`` for each pair, -1 where there
    is no edge, in the values' dtype."""
    data, indices, indptr = _csr_parts(csr)
    us = u.asnumpy().astype(_np.int64)
    vs = v.asnumpy().astype(_np.int64)
    out = _np.full(len(us), -1, data.dtype)
    for i, (a, b) in enumerate(zip(us, vs)):
        hit = _np.nonzero(indices[indptr[a]:indptr[a + 1]] == b)[0]
        if len(hit):
            out[i] = data[indptr[a] + hit[0]]
    return array(out, ctx=csr.context)


def dgl_adjacency(csr):
    """The graph's adjacency, a CSR of float32 ones."""
    from .sparse import csr_matrix

    return csr_matrix((torch.ones(csr.data.shape[0], dtype=torch.float32,
                                  device=csr.data._data.device),
                       csr.indices, csr.indptr), shape=csr.shape)


def dgl_graph_compact(*graphs, return_mapping=False, graph_sizes=(),
                      num_args=None):
    """Each sampled graph cut to its first ``graph_sizes[i]`` vertices
    (the sampler's padding dropped). With ``return_mapping`` the inputs
    are the graphs followed by their edge-value CSRs, and both are
    cut."""
    from .sparse import csr_matrix

    n_graphs = len(graphs) // 2 if return_mapping else len(graphs)
    if return_mapping and len(graphs) != 2 * n_graphs:
        raise ValueError(
            "return_mapping=True needs graphs followed by an equal "
            f"number of mapping CSRs, got {len(graphs)} inputs")
    if len(graph_sizes) != n_graphs:
        raise ValueError(
            f"graph_sizes must name one size per graph: got "
            f"{len(graph_sizes)} sizes for {n_graphs} graph(s)")

    def compact(g, size):
        data, indices, indptr = _csr_parts(g)
        size = int(size)
        sptr = indptr[:size + 1].copy()
        keep = int(sptr[-1])
        return csr_matrix((data[:keep], indices[:keep], sptr),
                          shape=(size, size), ctx=g.context)

    out = [compact(g, s) for g, s in zip(graphs[:n_graphs], graph_sizes)]
    if return_mapping:
        out += [compact(g, s)
                for g, s in zip(graphs[n_graphs:], graph_sizes)]
    return out


__all__ += ["dgl_csr_neighbor_uniform_sample",
            "dgl_csr_neighbor_non_uniform_sample", "dgl_subgraph",
            "edge_id", "dgl_adjacency", "dgl_graph_compact"]


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
