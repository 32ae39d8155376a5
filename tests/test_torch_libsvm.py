"""The port's ``LibSVMIter`` against the JAX package's on one LibSVM file
(made from a seed in ``tmp_path``): every batch's CSR parts, dense view,
label and ``pad``, with ``round_batch`` on and off and a separate
``label_libsvm``, over two epochs (``reset``)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


def _write(path, rows, features, seed, max_nnz=6, blank=True):
    rs = np.random.RandomState(seed)
    with open(path, "w") as f:
        for r in range(rows):
            nnz = rs.randint(0, max_nnz + 1)
            idx = np.sort(rs.choice(features, nnz, replace=False))
            vals = rs.randn(nnz)
            f.write(f"{rs.randint(2)} " + " ".join(
                f"{i}:{v:.7g}" for i, v in zip(idx, vals)) + "\n")
            if blank and r == rows // 2:
                f.write("\n")   # an empty line is skipped by both


def _batches(it):
    out = []
    for b in it:
        csr = b.data[0]
        out.append({"data": csr.data.asnumpy(),
                    "indices": csr.indices.asnumpy().astype(np.int64),
                    "indptr": csr.indptr.asnumpy().astype(np.int64),
                    "dense": csr.asnumpy(), "shape": csr.shape,
                    "label": b.label[0].asnumpy(), "pad": b.pad})
    return out


@pytest.mark.parametrize("round_batch", [True, False])
@pytest.mark.parametrize("batch", [4, 7])
def test_libsvm_batches_match_jax(tmp_path, round_batch, batch):
    path = tmp_path / "train.libsvm"
    _write(path, 23, 40, seed=batch)
    kw = dict(data_libsvm=str(path), data_shape=(40,), batch_size=batch,
              round_batch=round_batch)
    it = mx.io.LibSVMIter(ctx=mx.cpu(), **kw)
    jit = jmx.io.LibSVMIter(**kw)
    assert it.provide_data[0].shape == jit.provide_data[0].shape
    assert it.provide_label[0].shape == jit.provide_label[0].shape
    for _ in range(2):
        got, want = _batches(it), _batches(jit)
        assert len(got) == len(want) == (-(-23 // batch) if round_batch
                                         else 23 // batch)
        for g, w in zip(got, want):
            for k in ("data", "indices", "indptr", "dense", "label"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert (g["pad"], g["shape"]) == (w["pad"], w["shape"])
        it.reset()
        jit.reset()
    if round_batch and 23 % batch:
        assert got[-1]["pad"] == batch - 23 % batch


def test_libsvm_label_file_and_context(tmp_path):
    path, labels = tmp_path / "x.libsvm", tmp_path / "y.libsvm"
    _write(path, 10, 12, seed=3, blank=False)
    labels.write_text("".join(f"{i % 3}.5 ignored\n" for i in range(10)))
    kw = dict(data_libsvm=str(path), data_shape=12, batch_size=4,
              label_libsvm=str(labels))
    with mx.cpu():
        got = _batches(mx.io.LibSVMIter(**kw))
    want = _batches(jmx.io.LibSVMIter(**kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["label"], w["label"])
        np.testing.assert_array_equal(g["dense"], w["dense"])
    with mx.cpu():
        b = next(iter(mx.io.LibSVMIter(**kw)))
    assert b.data[0].stype == "csr" and b.data[0].context == mx.cpu()
    assert b.data[0].data.dtype == torch.float32
    assert b.data[0].indices.dtype == torch.int64
    assert b.label[0].dtype == torch.float32
