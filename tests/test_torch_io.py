"""The port's ``mx.io.NDArrayIter`` against the JAX package's on the CPU:
the same batches, padding and epoch order for every last-batch mode, with
and without shuffling from the same numpy generator state."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx


def _epochs(io, nd_ctx, data, label, n_epochs=2, **kw):
    it = io.NDArrayIter(data, label, **kw)
    out = []
    for _ in range(n_epochs):
        with nd_ctx:
            for batch in it:
                out.append(([d.asnumpy() for d in batch.data],
                            [lb.asnumpy() for lb in batch.label],
                            batch.pad))
        it.reset()
    return out, it.provide_data, it.provide_label


@pytest.mark.parametrize("mode", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_jax(mode, shuffle):
    rs = np.random.RandomState(0)
    data = rs.randn(10, 3).astype(np.float32)
    label = rs.randint(0, 4, 10).astype(np.float32)
    kw = dict(batch_size=4, last_batch_handle=mode, shuffle=shuffle)
    got, pd, pl = _epochs(mx.io, mx.cpu(), data, label,
                          rng=np.random.RandomState(1), **kw)
    want, jpd, jpl = _epochs(jmx.io, jmx.cpu(), data, label,
                             rng=np.random.RandomState(1), **kw)
    assert len(got) == len(want) > 0
    for (d, lb, pad), (jd, jlb, jpad) in zip(got, want):
        assert pad == jpad
        for a, b in zip(d + lb, jd + jlb):
            np.testing.assert_array_equal(a, b)
    assert [(x.name, x.shape) for x in pd + pl] == \
        [(x.name, x.shape) for x in jpd + jpl]


def test_ndarray_iter_names_and_checks():
    x = np.zeros((5, 2), np.float32)
    it = mx.io.NDArrayIter({"a": x, "b": x}, batch_size=5, label_name=None)
    assert [d.name for d in it.provide_data] == ["a", "b"]
    assert it.provide_label == []
    with mx.cpu():
        batch = next(iter(it))
    assert batch.label == [] and batch.pad == 0
    with pytest.raises(ValueError, match="batch_size"):
        mx.io.NDArrayIter(x, batch_size=6)
    with pytest.raises(TypeError, match="list of NDArrays"):
        mx.io.DataBatch(data=x)
