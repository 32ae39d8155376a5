"""Sparse storage types: ``row_sparse`` and ``csr``.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (MXNet 1.x
``python/mxnet/ndarray/sparse.py``). Row-sparse arrays carry the
gradients of large embeddings and factor tables (the kvstore's
``row_sparse_pull`` and lazy SGD); CSR arrays carry sparse input
features (``LibSVMIter``, the DGL graph ops).

Storage is sparse: a :class:`RowSparseNDArray` holds ``(data,
indices)`` and a :class:`CSRNDArray` ``(data, indices, indptr)``, each
part a tensor on the array's device (the card unless ``ctx`` says
otherwise). The dense view is made on the first dense access (``_data``,
which every op and ``asnumpy`` reads), as MXNet's storage fallback:

* a row-sparse array's dense view scatter-ADDS its rows, so duplicate
  indices sum, as the JAX ``_densify_fn``'s ``.at[].add``: in input
  order, one ``index_add_`` per occurrence level (``_add_rows``), so the
  card gives the CPU's bits; a CSR array's writes each value
  (``index_put_``), as the JAX ``.at[].set``;
* a dense write (``_rebind``, or ``_data = ...``) marks a row-sparse
  array's parts stale; its ``data``/``indices`` are then derived again
  from the dense contents (the non-zero rows).

The sparse-aware paths never make the dense view: ``sparse_add`` (a row
union: concatenation, ``torch.unique`` and ``_add_rows``),
``merge_duplicates``, ``retain``, ``_update`` (the ``row_sparse_pull``
write-back) and the kvstore's and lazy SGD's use of the parts. They run
eagerly and read sizes back to the host (``torch.unique``'s output, the
duplicate check, ``retain``'s mask), as the JAX functions read indices
back: none of them may run inside a captured CUDA graph.

Indices are int64 (the JAX package's are int32 without x64; the values
agree). ``row_sparse_array``, ``csr_matrix`` and ``cast_storage`` take
``ctx=`` (the JAX functions ignore it) and put the parts there, the
current context (the card) by default; from an NDArray they stay on its
device.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import canonical_dtype
from ..context import current_context
from .ndarray import NDArray

__all__ = ["RowSparseNDArray", "CSRNDArray", "row_sparse_array",
           "csr_matrix", "cast_storage", "sparse_add", "merge_duplicates"]


def _part(x, ctx, dtype=None):
    """One sparse part as an NDArray: an NDArray or tensor as it is (moved
    to ``ctx`` when one is given), host data onto ``ctx`` or the current
    context."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return NDArray(x.detach().to(
            device=ctx.torch_device() if ctx is not None else x.device,
            dtype=canonical_dtype(dtype) if dtype else x.dtype))
    if dtype is None and not isinstance(x, _np.ndarray):
        dtype = "float32"   # Python lists and numbers, as nd.array
    return NDArray(_np.asarray(x), ctx=ctx or current_context(),
                   dtype=dtype)


def _index(x, ctx):
    return _part(x, ctx, "int64")


def _add_rows(out, rows, vals):
    """``out[rows[i]] += vals[i]`` for every ``i`` in order: one
    ``index_add_`` per occurrence level (the first occurrence of each row,
    then the second, ...), so that no launch adds to a row twice. On a card
    that is exact and the same bits as the CPU's, where one ``index_add_``
    over repeated rows sums in the order its atomics land."""
    n = rows.numel()
    if n == 0:
        return out
    order = torch.argsort(rows, stable=True)
    srt = rows[order]
    pos = torch.arange(n, device=rows.device)
    first = torch.ones(n, dtype=torch.bool, device=rows.device)
    first[1:] = srt[1:] != srt[:-1]
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    level = torch.empty_like(pos)
    level[order] = pos - start
    levels = int(level.max()) + 1   # a host read, as the JAX merge makes
    if levels == 1:
        return out.index_add_(0, rows, vals)
    for k in range(levels):
        sel = (level == k).nonzero().squeeze(1)
        out.index_add_(0, rows.index_select(0, sel),
                       vals.index_select(0, sel))
    return out


class RowSparseNDArray(NDArray):
    """Values ``data`` for the rows listed in ``indices``; every other
    row is zero."""

    __slots__ = ("_rs_data", "_rs_indices", "_dense_shape", "_dense_cache",
                 "_rs_stale")

    def __init__(self, data, indices, shape, ctx=None):
        self._rs_data = _part(data, ctx)
        self._rs_indices = _index(indices, ctx if ctx is not None
                                  else self._rs_data.context)
        self._dense_shape = tuple(int(d) for d in shape)
        self._dense_cache = None
        self._rs_stale = False
        self._grad_req = "null"

    @property
    def _data(self):
        """The dense view, made at first dense access."""
        if self._dense_cache is None:
            vals = self._rs_data._data
            out = torch.zeros(self._dense_shape, dtype=vals.dtype,
                              device=vals.device)
            self._dense_cache = _add_rows(out, self._rs_indices._data, vals)
        return self._dense_cache

    @_data.setter
    def _data(self, raw):
        # a dense write: the parts no longer describe the contents
        self._dense_cache = raw
        self._rs_stale = True

    def _refresh_sparse(self):
        """The parts again from the dense contents (its non-zero rows),
        after a dense write."""
        dense = self._dense_cache.detach()
        nz = dense.reshape(dense.shape[0], -1).ne(0).any(dim=1) \
            .nonzero().squeeze(1)
        self._rs_indices = NDArray(nz)
        self._rs_data = NDArray(dense.index_select(0, nz))
        self._rs_stale = False

    # metadata that reads no dense view
    @property
    def shape(self):
        return self._dense_shape

    @property
    def dtype(self):
        if self._rs_stale:
            return self._dense_cache.dtype
        return self._rs_data.dtype

    @property
    def size(self):
        return int(_np.prod(self._dense_shape, dtype=_np.int64))

    @property
    def ndim(self):
        return len(self._dense_shape)

    @property
    def context(self):
        return self._rs_data.context

    ctx = context

    @property
    def stype(self):
        return "row_sparse"

    @property
    def data(self):
        if self._rs_stale:
            self._refresh_sparse()
        return self._rs_data

    @property
    def indices(self):
        if self._rs_stale:
            self._refresh_sparse()
        return self._rs_indices

    def wait_to_read(self):
        (NDArray(self._dense_cache) if self._rs_stale
         else self._rs_data).wait_to_read()

    def copy(self):
        return RowSparseNDArray(self.data._data.clone(),
                                self.indices._data.clone(),
                                self._dense_shape)

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data)
        if stype == "row_sparse":
            return self
        raise ValueError(f"cannot cast row_sparse to {stype}")

    def _update(self, rows, indices):
        """Replace the contents with ``rows`` at ``indices`` (the
        ``row_sparse_pull`` write-back); stays sparse."""
        ctx = self.context
        self._rs_data = _part(rows, ctx)
        self._rs_indices = _index(indices, ctx)
        self._dense_cache = None
        self._rs_stale = False

    def retain(self, indices):
        """Only the rows of this array that ``indices`` lists (MXNet's
        ``sparse.retain``), a new row-sparse array."""
        cur = self.indices._data
        req = _index(indices, self.context)._data
        keep = torch.isin(cur, req)
        return RowSparseNDArray(self.data._data[keep], cur[keep],
                                self._dense_shape)


class CSRNDArray(NDArray):
    """A compressed sparse row matrix: row ``r``'s values are
    ``data[indptr[r]:indptr[r + 1]]`` in the columns ``indices[...]``."""

    __slots__ = ("_csr_data", "_csr_indices", "_csr_indptr", "_dense_shape",
                 "_dense_cache")

    def __init__(self, data, indices, indptr, shape, ctx=None):
        self._csr_data = _part(data, ctx)
        ctx = ctx if ctx is not None else self._csr_data.context
        self._csr_indices = _index(indices, ctx)
        self._csr_indptr = _index(indptr, ctx)
        self._dense_shape = tuple(int(d) for d in shape)
        self._dense_cache = None
        self._grad_req = "null"

    @property
    def _data(self):
        if self._dense_cache is None:
            vals = self._csr_data._data
            ptr = self._csr_indptr._data
            rows = torch.repeat_interleave(
                torch.arange(ptr.numel() - 1, device=ptr.device),
                ptr[1:] - ptr[:-1])
            out = torch.zeros(self._dense_shape, dtype=vals.dtype,
                              device=vals.device)
            out[rows, self._csr_indices._data] = vals
            self._dense_cache = out
        return self._dense_cache

    @_data.setter
    def _data(self, raw):
        self._dense_cache = raw

    @property
    def shape(self):
        return self._dense_shape

    @property
    def dtype(self):
        return self._csr_data.dtype

    @property
    def size(self):
        return int(_np.prod(self._dense_shape, dtype=_np.int64))

    @property
    def ndim(self):
        return len(self._dense_shape)

    @property
    def context(self):
        return self._csr_data.context

    ctx = context

    @property
    def stype(self):
        return "csr"

    @property
    def data(self):
        return self._csr_data

    @property
    def indices(self):
        return self._csr_indices

    @property
    def indptr(self):
        return self._csr_indptr

    def wait_to_read(self):
        self._csr_data.wait_to_read()

    def tostype(self, stype):
        if stype == "default":
            return NDArray(self._data)
        if stype == "csr":
            return self
        raise ValueError(f"cannot cast csr to {stype}")


def sparse_add(a, b):
    """The sum of two row-sparse arrays without a dense view: the union of
    their rows (sorted), rows in both summed (MXNet's ``ReduceRowSparse``,
    ``src/kvstore/comm.h``). ``torch.unique`` reads the union's size back
    to the host; the values stay on the device."""
    if a.shape != b.shape:
        raise ValueError(f"sparse_add: shapes {a.shape} and {b.shape}")
    idx = torch.cat([a.indices._data, b.indices._data])
    vals = torch.cat([a.data._data, b.data._data])
    uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
    out = torch.zeros((uniq.numel(),) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    return RowSparseNDArray(_add_rows(out, inv, vals), uniq, a.shape)


def merge_duplicates(rs):
    """``rs`` with duplicate row indices summed into one row each (sorted
    indices); ``rs`` itself when its indices are unique. The sparse-aware
    updates need unique rows: one ``index_add_`` on a card is exact only
    then. Repeated rows sum in their input order, as JAX's
    ``np.add.at``."""
    idx = rs.indices._data
    uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
    if uniq.numel() == idx.numel():
        return rs
    vals = rs.data._data
    out = torch.zeros((uniq.numel(),) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    return RowSparseNDArray(_add_rows(out, inv, vals), uniq, rs.shape)


def _dense_tensor(arg, ctx, dtype):
    if isinstance(arg, NDArray):
        t = arg._data.detach()
        if ctx is not None:
            t = t.to(ctx.torch_device())
    else:
        t = NDArray(_np.asarray(arg), ctx=ctx or current_context())._data
    return t.to(canonical_dtype(dtype)) if dtype else t


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A row-sparse array from ``(data, indices)`` and ``shape``, or from
    a dense array (numpy or NDArray: its non-zero rows)."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        if dtype is not None:
            data = _part(data, ctx, dtype)
        return RowSparseNDArray(data, indices, shape, ctx=ctx)
    dense = _dense_tensor(arg1, ctx, dtype)
    nz = dense.reshape(dense.shape[0], -1).ne(0).any(dim=1) \
        .nonzero().squeeze(1)
    return RowSparseNDArray(dense.index_select(0, nz), nz, dense.shape)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSR matrix from ``(data, indices, indptr)`` and ``shape``, or
    from a dense 2-D array (its non-zero values, row by row)."""
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if dtype is not None:
            data = _part(data, ctx, dtype)
        return CSRNDArray(data, indices, indptr, shape, ctx=ctx)
    dense = _dense_tensor(arg1, ctx, dtype)
    rows, cols = dense.nonzero(as_tuple=True)
    counts = torch.bincount(rows, minlength=dense.shape[0])
    indptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    return CSRNDArray(dense[rows, cols], cols, indptr, dense.shape)


def cast_storage(arr, stype):
    """``arr`` in storage ``stype``: ``"default"`` (dense),
    ``"row_sparse"`` or ``"csr"`` (2-D only)."""
    if stype == "default":
        return NDArray(arr._data)
    if stype == "row_sparse":
        return row_sparse_array(arr)
    if stype == "csr":
        if arr.ndim != 2:
            raise ValueError("csr requires 2-D")
        return csr_matrix(arr)
    raise ValueError(f"unknown stype {stype!r}")
