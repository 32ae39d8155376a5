"""The fault-injection points of the ported modules, against the JAX
package's (ROADMAP C32): a ``raise`` spec at each of ``ckpt.write``,
``kvstore.push``, ``kvstore.sync``, ``trainer.step``, ``host.sync``,
``io.fetch`` and ``io.decode`` fires ``InjectedFault`` in both packages
at the same call, and each package's ``faults.stats()`` counts one
invocation and one fire there. With no schedule the points stay quiet
(``faults.ARMED`` is False and nothing is counted). A ``nan`` spec at
``trainer.step`` poisons the port's batch, which its nan guard skips.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import faults as jfaults
from mxnet_tpu_torch import faults

CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _fires(pkg_faults, point, call):
    pkg_faults.configure(f"{point}:raise")
    with pytest.raises(pkg_faults.InjectedFault, match=point):
        call()
    assert pkg_faults.stats()[point] == (1, 1)


def _ckpt(pkg, tmp_path):
    from importlib import import_module

    ck = import_module(pkg.__name__ + ".checkpoint")
    path = str(tmp_path / f"{pkg.__name__}.bin")
    return lambda: ck.atomic_write(
        path, lambda p: open(p, "wb").write(b"x"))


def test_ckpt_write_fires_in_both(tmp_path):
    _fires(faults, "ckpt.write", _ckpt(mx, tmp_path))
    _fires(jfaults, "ckpt.write", _ckpt(jmx, tmp_path))
    assert not os.listdir(tmp_path)        # nothing written by either


@pytest.mark.parametrize("store", ["local", "dist_sync"])
def test_kvstore_push_fires_in_both(store):
    def push(pkg, ctx):
        kv = pkg.kv.create(store)
        kv.init(3, pkg.nd.ones((2,), ctx=ctx))
        return lambda: kv.push(3, pkg.nd.ones((2,), ctx=ctx))

    _fires(faults, "kvstore.push", push(mx, CPU))
    _fires(jfaults, "kvstore.push", push(jmx, jmx.cpu()))


@pytest.mark.parametrize("site", ["barrier", "cross_host_sum"])
def test_kvstore_sync_fires_in_both(site):
    def call(pkg, ctx):
        kv = pkg.kv.create("dist_sync")
        if site == "barrier":
            return kv.barrier
        return lambda: kv._cross_host_sum(pkg.nd.ones((2,), ctx=ctx))

    _fires(faults, "kvstore.sync", call(mx, CPU))
    _fires(jfaults, "kvstore.sync", call(jmx, jmx.cpu()))


def test_kvstore_sync_fires_at_a_bucket_resolve(monkeypatch):
    """The port's bucket pipeline (JAX ``buckets.py:282``): the point
    fires when a pull resolves the key's bucket, after the push."""
    monkeypatch.setenv("MXNET_TPU_BUCKET_FORCE", "1")
    kv = mx.kv.create("dist_sync")
    kv.init(3, mx.nd.ones((4,), ctx=CPU))
    out = mx.nd.zeros((4,), ctx=CPU)
    assert kv._bucketed(3)
    faults.configure("kvstore.sync:raise")
    kv.push(3, mx.nd.ones((4,), ctx=CPU))
    assert "kvstore.sync" not in faults.stats()
    with pytest.raises(faults.InjectedFault, match="kvstore.sync"):
        kv.pull(3, out=out)
    assert faults.stats()["kvstore.sync"] == (1, 1)


def _trainers():
    """One step's callable of a 2-layer MLP ShardedTrainer in each
    package, from the same batch."""
    from mxnet_tpu.parallel import DeviceMesh as JMesh
    from mxnet_tpu.parallel import ShardedTrainer as JTrainer
    from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

    rs = np.random.RandomState(0)
    x = rs.randn(4, 8).astype(np.float32)
    y = rs.randint(0, 3, size=4).astype(np.float32)

    def net(pkg):
        n = pkg.gluon.nn.HybridSequential()
        n.add(pkg.gluon.nn.Dense(8, activation="relu", in_units=8),
              pkg.gluon.nn.Dense(3, in_units=8))
        return n

    pn = net(mx)
    pn.initialize(ctx=CPU)
    pt = ShardedTrainer(pn, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                        {"learning_rate": 0.1}, nan_guard=True,
                        mesh=DeviceMesh({"dp": 1}, devices=[CPU]))
    jn = net(jmx)
    jn.initialize()
    jt = JTrainer(jn, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                  {"learning_rate": 0.1},
                  mesh=JMesh({"dp": 1}))
    return (lambda: pt.step(mx.nd.array(x, ctx=CPU),
                            mx.nd.array(y, ctx=CPU)), pt,
            lambda: jt.step(jmx.nd.array(x), jmx.nd.array(y)))


def test_trainer_step_fires_in_both():
    port_step, pt, jax_step = _trainers()
    _fires(faults, "trainer.step", port_step)
    _fires(jfaults, "trainer.step", jax_step)
    # nan: the poisoned batch reaches the step, whose guard skips it
    before = [p.data().asnumpy() for p in pt._params]
    faults.configure("trainer.step:nan")
    loss = port_step()
    assert not np.isfinite(loss.asnumpy()).all()
    assert pt.skipped_steps == 1
    for b, p in zip(before, pt._params):
        np.testing.assert_array_equal(b, p.data().asnumpy())


@pytest.mark.parametrize("read", ["wait_to_read", "asnumpy"])
def test_host_sync_fires_in_both(read):
    a = mx.nd.ones((2,), ctx=CPU)
    _fires(faults, "host.sync", getattr(a, read))
    # the JAX package's point is in _bounded_block (wait_to_read)
    _fires(jfaults, "host.sync", jmx.nd.ones((2,)).wait_to_read)


def test_io_fetch_fires_in_both():
    def it(pkg, ctx):
        data = np.arange(16, dtype=np.float32).reshape(8, 2)
        if ctx is None:
            src = pkg.io.NDArrayIter(data, batch_size=4)
        else:
            with ctx:
                src = pkg.io.NDArrayIter(data, batch_size=4)
        return pkg.io.PrefetchingIter(src)

    faults.configure("io.fetch:raise")
    with pytest.raises(faults.InjectedFault, match="io.fetch"):
        with CPU:
            it(mx, CPU).next()
    assert faults.stats()["io.fetch"] == (1, 1)
    jfaults.configure("io.fetch:raise")
    with pytest.raises(jfaults.InjectedFault, match="io.fetch"):
        it(jmx, None).next()
    assert jfaults.stats()["io.fetch"] == (1, 1)


def test_io_decode_fires_in_both(tmp_path):
    tokens = np.arange(100, dtype=np.int32)
    path = str(tmp_path / "tok.rec")
    mx.io.write_token_shard(path, tokens, 8)
    with CPU:
        pit = mx.io.TokenRecordIter(path, 8, batch_size=2)
        _fires(faults, "io.decode", pit.next)
    jit = jmx.io.TokenRecordIter(path, 8, batch_size=2)
    _fires(jfaults, "io.decode", jit.next)


def test_points_are_quiet_with_no_schedule(tmp_path):
    """Off, every point is one attribute read: nothing counted, nothing
    raised, through the same calls."""
    faults.reset()
    assert faults.ARMED is False
    _ckpt(mx, tmp_path)()
    kv = mx.kv.create("dist_sync")
    kv.init(3, mx.nd.ones((2,), ctx=CPU))
    kv.push(3, mx.nd.ones((2,), ctx=CPU))
    kv.barrier()
    mx.nd.ones((2,), ctx=CPU).asnumpy()
    assert faults.stats() == {}


def _jpeg_records(path, n=4):
    from mxnet_tpu import recordio as jrec

    rs = np.random.RandomState(0)
    w = jrec.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        img = rs.randint(0, 256, (24, 30, 3)).astype(np.uint8)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i), i, 0), img,
                                     quality=90, img_fmt=".jpg"))
    w.close()
    return path


def test_io_decode_fires_for_image_records_and_a_rejected_jpeg_is_retried(
        tmp_path, monkeypatch):
    """``io.decode`` at an ``ImageRecordIter`` batch in both packages; a
    JPEG record that the batch decode rejects once is decoded again under
    ``faults.retry`` and the batch equals a clean one."""
    from mxnet_tpu_torch import native

    path = _jpeg_records(str(tmp_path / "j.rec"))
    kw = dict(path_imgrec=path, data_shape=(3, 16, 16), batch_size=4)
    with CPU:
        _fires(faults, "io.decode", mx.io.ImageRecordIter(**kw).next)
    _fires(jfaults, "io.decode", jmx.io.ImageRecordIter(**kw).next)
    faults.reset()
    with CPU:
        clean = mx.io.ImageRecordIter(**kw).next().data[0].asnumpy()
    real, calls = native.decode_jpeg_batch, []

    def rejects_once(bufs, *args, **kwargs):
        out, failed = real(bufs, *args, **kwargs)
        calls.append(len(bufs))
        return (out, [1]) if len(calls) == 1 else (out, failed)

    monkeypatch.setattr(native, "decode_jpeg_batch", rejects_once)
    with CPU:
        got = mx.io.ImageRecordIter(**kw).next().data[0].asnumpy()
    assert calls == [4, 1]
    np.testing.assert_array_equal(got, clean)
