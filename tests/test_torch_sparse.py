"""The port's row-sparse and CSR arrays (mxnet_tpu_torch/ndarray/sparse.py)
against the JAX package's on the CPU, on the same numpy inputs:
construction from parts and from dense arrays, the dense view (duplicate
rows sum), ``stype``/``tostype``/``cast_storage``, ``sparse_add``,
``merge_duplicates``, ``retain``, the ``_sparse_retain`` and
``cast_storage`` ops and ``getnnz``. Indices are held exactly, float32
values to rtol 1e-6; the dense view is never made by the sparse-aware
functions (JAX tests/test_sparse_dist.py:31)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch.ndarray import sparse as sp

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


def _close(port, jax_arr):
    np.testing.assert_allclose(port.asnumpy(), jax_arr.asnumpy(), rtol=RTOL)


def _idx_eq(port, jax_arr):
    np.testing.assert_array_equal(port.asnumpy().astype(np.int64),
                                  jax_arr.asnumpy().astype(np.int64))


def _rows(seed, n_rows, nnz, width, dup=False):
    rs = np.random.RandomState(seed)
    idx = rs.choice(n_rows, nnz, replace=dup)
    return rs.randn(nnz, width).astype(np.float32), idx.astype(np.int64)


@pytest.mark.parametrize("dup", [False, True])
def test_row_sparse_construction_and_dense_view_match_jax(dup):
    vals, idx = _rows(0, 12, 6, 3, dup=dup)
    if dup:
        idx[:2] = idx[2]   # duplicate rows sum in the dense view
    p = sp.row_sparse_array((vals, idx), shape=(12, 3))
    j = jsp.row_sparse_array((vals, idx), shape=(12, 3))
    assert p.stype == "row_sparse" and p.shape == (12, 3)
    assert p._dense_cache is None and p.dtype == torch.float32
    assert p.context == mx.cpu() and p.size == 36 and p.ndim == 2
    _idx_eq(p.indices, j.indices)
    _close(p.data, j.data)
    assert p._dense_cache is None
    _close(p.tostype("default"), j.tostype("default"))
    _close(p, j)   # asnumpy reads the dense view
    assert p._dense_cache is not None


def test_row_sparse_from_dense_and_cast_storage_match_jax():
    rs = np.random.RandomState(1)
    dense = rs.randn(8, 4).astype(np.float32)
    dense[[0, 3, 6]] = 0
    for p, j in ((sp.row_sparse_array(dense), jsp.row_sparse_array(dense)),
                 (sp.cast_storage(mx.nd.array(dense), "row_sparse"),
                  jsp.cast_storage(jmx.nd.array(dense), "row_sparse")),
                 (mx.nd.array(dense).tostype("row_sparse"),
                  jmx.nd.array(dense).tostype("row_sparse"))):
        _idx_eq(p.indices, j.indices)
        _close(p.data, j.data)
        assert p.shape == j.shape
    assert mx.nd.array(dense).stype == "default"
    d = mx.nd.array(dense)
    assert d.tostype("default") is d
    _close(sp.cast_storage(sp.row_sparse_array(dense), "default"),
           jsp.cast_storage(jsp.row_sparse_array(dense), "default"))
    with pytest.raises(ValueError):
        sp.row_sparse_array(dense).tostype("csr")
    with pytest.raises(ValueError):
        sp.cast_storage(d, "blocked")


def test_csr_construction_dense_view_and_cast_match_jax():
    rs = np.random.RandomState(2)
    dense = (rs.rand(6, 9) > 0.7) * rs.randn(6, 9)
    dense = dense.astype(np.float32)
    p, j = sp.csr_matrix(dense), jsp.csr_matrix(dense)
    assert p.stype == "csr" and p.shape == (6, 9)
    for part in ("indices", "indptr"):
        _idx_eq(getattr(p, part), getattr(j, part))
    _close(p.data, j.data)
    assert p._dense_cache is None
    _close(p.tostype("default"), j.tostype("default"))
    q = sp.csr_matrix((j.data.asnumpy(), j.indices.asnumpy(),
                       j.indptr.asnumpy()), shape=(6, 9))
    _close(q, j)
    c = mx.nd.array(dense).tostype("csr")
    jc = jmx.nd.array(dense).tostype("csr")
    _idx_eq(c.indptr, jc.indptr)
    _close(sp.cast_storage(c, "default"), jsp.cast_storage(jc, "default"))
    with pytest.raises(ValueError, match="2-D"):
        sp.cast_storage(mx.nd.zeros((2, 2, 2)), "csr")
    with pytest.raises(ValueError):
        c.tostype("row_sparse")


@pytest.mark.parametrize("overlap", [0, 2, 5])
def test_sparse_add_is_a_row_union_like_jax(overlap):
    va, ia = _rows(3, 20, 5, 4)
    vb, _ = _rows(4, 20, 5, 4)
    ib = np.concatenate([ia[:overlap],
                         np.setdiff1d(np.arange(20), ia)[:5 - overlap]])
    pa, pb = (sp.row_sparse_array((v, i), shape=(20, 4))
              for v, i in ((va, ia), (vb, ib)))
    ja, jb = (jsp.row_sparse_array((v, i), shape=(20, 4))
              for v, i in ((va, ia), (vb, ib)))
    p, j = sp.sparse_add(pa, pb), jsp.sparse_add(ja, jb)
    assert p._dense_cache is None and pa._dense_cache is None
    _idx_eq(p.indices, j.indices)
    assert p.indices.shape[0] == 10 - overlap
    _close(p.data, j.data)
    _close(p, j)
    with pytest.raises(ValueError, match="shapes"):
        sp.sparse_add(pa, sp.row_sparse_array((va, ia), shape=(21, 4)))


def test_merge_duplicates_and_retain_match_jax():
    vals = np.arange(10, dtype=np.float32).reshape(5, 2)
    idx = np.array([4, 1, 4, 3, 1])
    p = sp.merge_duplicates(sp.RowSparseNDArray(vals, idx, (6, 2)))
    j = jsp.merge_duplicates(jsp.RowSparseNDArray(vals, idx, (6, 2)))
    _idx_eq(p.indices, j.indices)
    _close(p.data, j.data)
    assert p._dense_cache is None
    uniq = sp.RowSparseNDArray(vals[:3], [5, 0, 2], (6, 2))
    assert sp.merge_duplicates(uniq) is uniq
    for keep in ([0, 2], [1, 3], np.array([5, 2, 0])):
        r = uniq.retain(mx.nd.array(np.asarray(keep)))
        jr = jsp.RowSparseNDArray(vals[:3], [5, 0, 2], (6, 2)).retain(
            jmx.nd.array(np.asarray(keep)))
        _idx_eq(r.indices, jr.indices)
        _close(r.data, jr.data)
        assert r.shape == (6, 2) and uniq._dense_cache is None


def test_dense_write_marks_parts_stale_and_derives_them_again():
    p = sp.row_sparse_array((np.ones((2, 3), np.float32), [1, 4]),
                            shape=(6, 3))
    j = jsp.row_sparse_array((np.ones((2, 3), np.float32), [1, 4]),
                             shape=(6, 3))
    new = np.zeros((6, 3), np.float32)
    new[[0, 5]] = 2.0
    p._rebind(torch.from_numpy(new))
    j._rebind(jmx.nd.array(new)._data)
    assert p.dtype == torch.float32
    _idx_eq(p.indices, j.indices)
    _close(p.data, j.data)
    q = p.copy()
    _close(q, j)
    p._update(np.full((1, 3), 7.0, np.float32), [2])
    assert p._dense_cache is None
    assert p.asnumpy()[2].tolist() == [7.0] * 3


def test_sparse_retain_and_cast_storage_ops_match_jax():
    rs = np.random.RandomState(5)
    x = rs.randn(7, 3).astype(np.float32)
    keep = np.array([0, 4, 6], np.float32)
    got = mx.nd._sparse_retain(mx.nd.array(x), mx.nd.array(keep))
    want = jmx.nd._sparse_retain(jmx.nd.array(x), jmx.nd.array(keep))
    _close(got, want)
    _close(mx.nd.cast_storage(mx.nd.array(x), stype="row_sparse"),
           jmx.nd.cast_storage(jmx.nd.array(x), stype="row_sparse"))
    # the gradient reaches the kept rows only
    data = mx.nd.array(x)
    data.attach_grad(stype="row_sparse")
    with mx.autograd.record():
        y = mx.nd._sparse_retain(data, mx.nd.array(keep)).sum()
    y.backward()
    want_g = np.zeros_like(x)
    want_g[keep.astype(int)] = 1
    np.testing.assert_array_equal(data.grad.asnumpy(), want_g)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_getnnz_on_csr_and_dense_matches_jax(axis):
    rs = np.random.RandomState(6)
    dense = ((rs.rand(5, 8) > 0.6) * rs.randn(5, 8)).astype(np.float32)
    kw = {} if axis is None else {"axis": axis}
    got = mx.nd.contrib.getnnz(sp.csr_matrix(dense), **kw)
    want = jmx.nd.contrib.getnnz(jsp.csr_matrix(dense), **kw)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    assert got.dtype == torch.int64
    x = mx.sym.var("x")
    out = mx.sym.contrib.getnnz(x, **kw).eval_with(
        {"x": mx.nd.array(dense)})
    out = out[0] if isinstance(out, (list, tuple)) else out
    np.testing.assert_array_equal(out.asnumpy(), want.asnumpy())


def test_sparse_arrays_take_ctx_and_move_between_devices():
    p = sp.row_sparse_array((np.ones((1, 2), np.float32), [3]),
                            shape=(4, 2), ctx=mx.cpu())
    assert p.context == mx.cpu() and p.indices.dtype == torch.int64
    assert p.as_in_context(mx.cpu()) is p
    c = sp.csr_matrix(([1.0, 2.0], [0, 2], [0, 1, 2]), shape=(2, 3),
                      ctx=mx.cpu())
    assert c.context == mx.cpu() and c.data.dtype == torch.float32
    np.testing.assert_array_equal(c.asnumpy(), [[1, 0, 0], [0, 0, 2]])
    assert mx.nd.sparse.RowSparseNDArray is sp.RowSparseNDArray
    assert "sparse" in dir(mx.nd)
