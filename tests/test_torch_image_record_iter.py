"""``mx.io`` on the CPU: the port's ``ImageRecordIter`` and the other
iterators against the JAX package's.

``ImageRecordIter`` gives the JAX iterator's batches bit for bit over
JPEG, PNG and mixed record sets (JPEG through both packages' native
libjpeg decode, PNG through the port's decoder and Pillow's resample
against PIL), with and without ``rand_crop``/``rand_mirror``/
``color_jitter``, through one decode thread or several, with and without
the producer thread, and over the plain versions; a damaged record is
zero-filled with a warning in both. ``state_dict`` resumes a stream
mid-epoch bit for bit (the JAX package's states load here), and
``num_parts``/``part_index`` tile an epoch as the JAX parts do. Then
``NDArrayIter``'s ``state_dict``, ``ResizeIter``, ``PrefetchingIter``,
``MNISTIter`` and ``CSVIter`` against the JAX ones; ``Module.fit`` over
the record iterator (its label, named ``label``, bound by position); a
bfloat16 graph fed float32 records refused at bind by both packages; and
``ShardedTrainer.save_checkpoint(data_iter=)`` / ``resume(data_iter=)``
restoring the stream bit for bit (``tests/test_dataplane.py:282`` for the
JAX trainer)."""
import gzip
import io
import os
import struct
import tempfile
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import checkpoint, native
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import vision

CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with CPU:
        yield


def _write(path, n, fmt, seed=0, corrupt=(), label_width=1, hw=(20, 50)):
    """A record set packed by the JAX package (PIL encoders)."""
    rs = np.random.RandomState(seed)
    w = jrec.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        h, ww = rs.randint(*hw, 2)
        img = rs.randint(0, 256, (h, ww, 3)).astype(np.uint8)
        f = fmt if fmt != "mix" else (".png" if i % 3 else ".jpg")
        label = float(i % 7) if label_width == 1 else \
            (np.arange(label_width) + i).astype(np.float32)
        body = jrec.pack_img(jrec.IRHeader(0, label, i, 0), img,
                             quality=90, img_fmt=f)
        if i in corrupt:
            body = body[:40] + b"garbage" * 10
        w.write_idx(i, body)
    w.close()
    return path


def _batches(it):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in it]


def _same(a, b):
    assert len(a) == len(b) > 0
    for (d1, l1, p1), (d2, l2, p2) in zip(a, b):
        assert d1.dtype == d2.dtype == np.float32
        assert np.array_equal(d1, d2) and np.array_equal(l1, l2)
        assert p1 == p2


AUG = {"plain": {},
       "crop_mirror": dict(rand_crop=True, rand_mirror=True),
       "everything": dict(rand_crop=True, rand_mirror=True, shuffle=True,
                          color_jitter=0.3, mean_r=123.68, mean_g=116.28,
                          mean_b=103.53, std_r=58.395, std_g=57.12,
                          std_b=57.375, scale=0.5)}


@pytest.mark.parametrize("fmt", [".png", ".jpg", "mix"])
@pytest.mark.parametrize("aug", sorted(AUG))
def test_batches_match_the_jax_iterator(tmp_path, fmt, aug):
    path = _write(str(tmp_path / "r.rec"), 19, fmt)
    kw = dict(path_imgrec=path, data_shape=(3, 24, 32), batch_size=6,
              seed=3, **AUG[aug])
    want = _batches(jmx.io.ImageRecordIter(**kw))
    assert len(want) == 4
    _same(_batches(mx.io.ImageRecordIter(**kw)), want)
    _same(_batches(mx.io.ImageRecordIter(preprocess_threads=1,
                                         prefetch_buffer=0, **kw)), want)
    with native.plain_versions():
        _same(_batches(mx.io.ImageRecordIter(**kw)), want)


@pytest.mark.parametrize("round_batch,label_width", [(False, 1), (True, 3)])
def test_epoch_geometry_matches(tmp_path, round_batch, label_width):
    path = _write(str(tmp_path / "g.rec"), 11, ".png",
                  label_width=label_width)
    kw = dict(path_imgrec=path, data_shape=(3, 16, 16), batch_size=4,
              round_batch=round_batch, label_width=label_width,
              shuffle=True, seed=9)
    want = _batches(jmx.io.ImageRecordIter(**kw))
    it = mx.io.ImageRecordIter(**kw)
    _same(_batches(it), want)
    assert len(want) == (3 if round_batch else 2)
    assert it.provide_label[0].shape == ((4,) if label_width == 1
                                         else (4, label_width))
    it.reset()       # a second epoch reshuffles as the JAX one does
    jit = jmx.io.ImageRecordIter(**kw)
    _batches(jit)
    jit.reset()
    _same(_batches(it), _batches(jit))


def test_a_damaged_record_is_zero_filled_with_a_warning(tmp_path):
    path = _write(str(tmp_path / "c.rec"), 9, "mix", corrupt=(4,))
    kw = dict(path_imgrec=path, data_shape=(3, 16, 16), batch_size=9,
              rand_crop=True, mean_r=10.0)
    with pytest.warns(UserWarning, match="1 corrupt image"):
        got = mx.io.ImageRecordIter(**kw).next()
    _same([(got.data[0].asnumpy(), got.label[0].asnumpy(), got.pad)],
          _batches(jmx.io.ImageRecordIter(**kw)))
    assert np.all(got.data[0].asnumpy()[4, 0] == -10.0)


def _raw_png(arr, interlace=0, depth=8):
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(data, zlib.crc32(kind)))

    return native.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, 2, 0, 0, interlace)) + chunk(
        b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def test_an_unported_png_variant_raises_through_next(tmp_path):
    path = str(tmp_path / "i.rec")
    w = mx.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    arr = np.zeros((8, 8, 3), np.uint8)
    w.write_idx(0, mx.recordio.pack((0, 1.0, 0, 0), _raw_png(arr)))
    w.write_idx(1, mx.recordio.pack((0, 1.0, 1, 0),
                                    _raw_png(arr, interlace=1)))
    w.close()
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                               batch_size=2)
    with pytest.raises(MXNetError, match="interlaced .* not ported"):
        it.next()


def test_jpeg_records_raise_without_libjpeg(tmp_path, monkeypatch):
    path = _write(str(tmp_path / "j.rec"), 4, "mix")
    monkeypatch.setattr(native, "_libjpeg_found", lambda cxx: False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_status", {})
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 16, 16),
                               batch_size=4)
    with pytest.raises(MXNetError, match="libjpeg"):
        it.next()
    assert native.status()["jpeg"] is False


def _aug_kw(rec, **over):
    """tests/test_dataplane.py:45."""
    kw = dict(path_imgrec=rec, data_shape=(3, 24, 24), batch_size=4,
              shuffle=True, rand_crop=True, rand_mirror=True,
              color_jitter=0.2, seed=5, round_batch=False,
              prefetch_buffer=0, num_parts=1, part_index=0)
    kw.update(over)
    return kw


@pytest.mark.parametrize("prefetch", [0, 2])
def test_state_dict_resumes_mid_epoch_bit_for_bit(tmp_path, prefetch):
    path = _write(str(tmp_path / "s.rec"), 24, "mix")
    kw = _aug_kw(path, prefetch_buffer=prefetch)
    ref = _batches(mx.io.ImageRecordIter(**kw))
    it = mx.io.ImageRecordIter(**kw)
    for _ in range(2):
        it.next()
    st = it.state_dict()
    assert st["consumed"] == 2 and st["global_pos"] == 8
    it2 = mx.io.ImageRecordIter(**kw)
    it2.load_state_dict(st)
    _same(_batches(it2), ref[2:])
    # the JAX iterator's state, cut at the same place, loads here
    jit = jmx.io.ImageRecordIter(**kw)
    for _ in range(2):
        jit.next()
    jst = jit.state_dict()
    assert jst == st
    it3 = mx.io.ImageRecordIter(**kw)
    it3.load_state_dict(jst)
    _same(_batches(it3), _batches(jit))
    with pytest.raises(ValueError, match="global batch boundary"):
        mx.io.ImageRecordIter(**_aug_kw(path, batch_size=5)) \
            .load_state_dict(st)


def test_parts_tile_the_epoch_as_the_jax_parts_do(tmp_path):
    path = _write(str(tmp_path / "p.rec"), 24, ".png")
    labels = []
    for part in range(2):
        kw = _aug_kw(path, num_parts=2, part_index=part)
        got = _batches(mx.io.ImageRecordIter(**kw))
        _same(got, _batches(jmx.io.ImageRecordIter(**kw)))
        labels += [float(v) for b in got for v in b[1]]
    whole = [float(v) for b in _batches(mx.io.ImageRecordIter(
        **_aug_kw(path))) for v in b[1]]
    assert sorted(labels) == sorted(whole)
    # a 2-part cut resumes on one part at the same global position
    it = mx.io.ImageRecordIter(**_aug_kw(path, num_parts=2, part_index=0))
    it.next()
    one = mx.io.ImageRecordIter(**_aug_kw(path, batch_size=8))
    one.load_state_dict(it.state_dict())
    assert one.state_dict()["global_pos"] == 8
    with pytest.raises(ValueError, match="part_index 2 is outside"):
        mx.io.ImageRecordIter(**_aug_kw(path, num_parts=2, part_index=2))


def test_batches_land_on_the_context_given_at_construction(tmp_path):
    path = _write(str(tmp_path / "x.rec"), 4, ".png")
    it = mx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 8, 8),
                               batch_size=2)
    b = it.next()
    assert b.data[0].context == CPU and b.label[0].context == CPU
    assert it.data_wait_ms and it.stage_ms()[0]["images"] == 2
    assert set(it.stage_ms()[0]) >= {"read", "inflate", "decode",
                                     "normalize", "produce"}
    it.close()


# --------------------------------------------------------- the wrappers --

def test_ndarray_iter_state_dict_matches_the_jax_one():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20, dtype=np.float32)
    for handle in ("pad", "discard", "roll_over"):
        kw = dict(batch_size=6, shuffle=True, last_batch_handle=handle)
        it = mx.io.NDArrayIter(x, y, rng=np.random.RandomState(1), **kw)
        jit = jmx.io.NDArrayIter(x, y, rng=np.random.RandomState(1), **kw)
        it.next()
        jit.next()
        assert it.state_dict() == jit.state_dict()
        rest = [b.data[0].asnumpy() for b in jit]
        fresh = mx.io.NDArrayIter(x, y, **kw)
        fresh.load_state_dict(it.state_dict())
        got = [b.data[0].asnumpy() for b in fresh]
        assert len(got) == len(rest) and all(
            np.array_equal(a, b) for a, b in zip(got, rest))


def test_resize_and_prefetching_iters_match(tmp_path):
    x = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    got = [b.data[0].asnumpy() for b in mx.io.ResizeIter(
        mx.io.NDArrayIter(x, batch_size=4), 5)]
    want = [b.data[0].asnumpy() for b in jmx.io.ResizeIter(
        jmx.io.NDArrayIter(x, batch_size=4), 5)]
    assert len(got) == len(want) == 5
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    path = _write(str(tmp_path / "f.rec"), 16, ".png")
    kw = _aug_kw(path)
    pf = mx.io.PrefetchingIter(mx.io.ImageRecordIter(**kw), device=CPU)
    ref = _batches(mx.io.ImageRecordIter(**kw))
    first = pf.next()
    assert np.array_equal(first.data[0].asnumpy(), ref[0][0])
    st = pf.state_dict()
    assert st["delivered"] == 1 and st["iters"][0]["consumed"] == 1
    pf2 = mx.io.PrefetchingIter(mx.io.ImageRecordIter(**kw))
    pf2.load_state_dict(st)
    _same(_batches(pf2), ref[1:])
    assert len(pf.data_wait_ms) == 1
    with pytest.raises(MXNetError, match="multi-card data parallelism"):
        mx.io.PrefetchingIter(mx.io.NDArrayIter(x, batch_size=2), mesh=1)
    with pytest.raises(MXNetError, match="multi-card data parallelism"):
        mx.io.DeviceStager(shardings=(1, 2))
    with pytest.raises(MXNetError, match="LibSVMIter is not ported"):
        mx.io.LibSVMIter("x.libsvm", (4,))


def test_mnist_and_csv_iters_match(tmp_path):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (30, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 30).astype(np.uint8)
    ip, lp = str(tmp_path / "i.gz"), str(tmp_path / "l")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 30, 28, 28) + imgs.tobytes())
    with open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 30) + labels.tobytes())
    for kw in ({}, {"flat": True, "shuffle": False},
               {"num_parts": 2, "part_index": 1}):
        got = _batches(mx.io.MNISTIter(ip, lp, batch_size=8, **kw))
        _same(got, _batches(jmx.io.MNISTIter(ip, lp, batch_size=8, **kw)))
    dp, lp2 = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dp, rs.rand(10, 6), delimiter=",")
    np.savetxt(lp2, rs.randint(0, 3, 10), delimiter=",")
    for rb in (True, False):
        kw = dict(data_shape=(2, 3), label_csv=lp2, batch_size=4,
                  round_batch=rb)
        _same(_batches(mx.io.CSVIter(dp, **kw)),
              _batches(jmx.io.CSVIter(dp, **kw)))


# ------------------------------------------------ Module and the trainer --

def _thumbnail_symbol(pkg, vis, dtype="float32"):
    net = vis.get_model("resnet18_v1", classes=10, thumbnail=True,
                        prefix="rec_")
    net.initialize(pkg.init.Xavier())
    x = pkg.nd.zeros((1, 3, 16, 16))
    if dtype != "float32":
        net.cast(dtype)
        x = x.astype(dtype)
    net(x)
    with tempfile.TemporaryDirectory() as d:
        net.export(os.path.join(d, "n"), 0)
        sym, _, _ = pkg.model.load_checkpoint(os.path.join(d, "n"), 0)
    return pkg.sym.SoftmaxOutput(sym, pkg.sym.var("softmax_label"),
                                 name="softmax")


def test_module_fit_binds_the_record_label_by_position(tmp_path):
    path = _write(str(tmp_path / "m.rec"), 16, ".png")
    kw = dict(path_imgrec=path, data_shape=(3, 16, 16), batch_size=8,
              shuffle=True, rand_crop=True, rand_mirror=True)
    it = mx.io.ImageRecordIter(**kw)
    assert it.provide_label[0].name == "label"
    mod = mx.mod.Module(_thumbnail_symbol(mx, vision), context=CPU)
    seen = []
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.01},
            initializer=mx.init.Xavier(),
            batch_end_callback=lambda p: seen.append(
                mod._exec.arg_dict["softmax_label"].asnumpy()))
    ref = mx.io.ImageRecordIter(**kw)
    ref.reset()                       # fit opens its epoch with reset()
    want = [b[1] for b in _batches(ref)]
    assert len(seen) == 2
    assert all(np.array_equal(a, b) for a, b in zip(seen, want))
    assert np.isfinite(mod.get_outputs()[0].asnumpy()).all()


def test_a_bfloat16_graph_fed_float32_records_is_refused_at_bind(tmp_path):
    """train_imagenet.py --dtype bfloat16 over ImageRecordIter: the JAX
    Module's bind fails graph verification (float32 data into a bfloat16
    Convolution); the port refuses at bind the same way."""
    path = _write(str(tmp_path / "b.rec"), 8, ".png")
    kw = dict(path_imgrec=path, data_shape=(3, 16, 16), batch_size=4)
    jmod = jmx.mod.Module(_thumbnail_symbol(jmx, jvision, "bfloat16"),
                          context=jmx.cpu())
    jit = jmx.io.ImageRecordIter(**kw)
    with pytest.raises(Exception, match="same dtypes, got float32, "
                                        "bfloat16"):
        jmod.bind(jit.provide_data, jit.provide_label)
    mod = mx.mod.Module(_thumbnail_symbol(mx, vision, "bfloat16"),
                        context=CPU)
    it = mx.io.ImageRecordIter(**kw)
    with pytest.raises(MXNetError, match="graph verification failed: .* "
                                         "one dtype, got float32, bfloat16"):
        mod.bind(it.provide_data, it.provide_label)


def test_trainer_checkpoint_carries_data_state(tmp_path):
    """tests/test_dataplane.py:282 over the port: the stream position in
    the checkpoint's meta, restored by resume(data_iter=)."""
    from mxnet_tpu_torch.gluon import loss as gloss, nn
    from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

    rec = _write(str(tmp_path / "t.rec"), 40, "mix", hw=(28, 36))

    def build(seed):
        mx.random.seed(seed)
        net = nn.HybridSequential()
        net.add(nn.Dense(8, activation="relu"), nn.Dense(2))
        net.initialize(mx.init.Xavier(), ctx=CPU)
        net(mx.nd.zeros((2, 3 * 24 * 24)))
        return ShardedTrainer(net, gloss.L2Loss(), "sgd",
                              {"learning_rate": 0.01},
                              mesh=DeviceMesh({"dp": 1}, devices=[CPU]))

    manager = checkpoint.CheckpointManager(str(tmp_path / "ck"),
                                           prefix="dp", keep=3)
    it = mx.io.ImageRecordIter(**_aug_kw(rec))
    ref = _batches(mx.io.ImageRecordIter(**_aug_kw(rec)))
    trainer = build(0)
    for _ in range(3):
        b = it.next()
        trainer.step(b.data[0].reshape((4, -1)), mx.nd.zeros((4, 2)))
    trainer.save_checkpoint(manager, epoch=1, data_iter=it)
    entry, _paths = manager.load()
    assert entry["meta"]["data_state"]["consumed"] == 3
    trainer2 = build(1)
    it2 = mx.io.ImageRecordIter(**_aug_kw(rec))
    assert trainer2.resume(manager, data_iter=it2)["epoch"] == 1
    _same(_batches(it2), ref[3:])
    assert all(np.array_equal(trainer2._state_tensors()[k].numpy(),
                              v.numpy())
               for k, v in trainer._state_tensors().items())


def test_many_decode_threads_and_fast_switching_give_the_same_batches(
        tmp_path):
    """More decode threads than cores, the interpreter switching threads
    every microsecond: each image's bytes and draws land in its own slot
    (the batches of one thread)."""
    import sys

    path = _write(str(tmp_path / "t.rec"), 40, "mix")
    kw = _aug_kw(path, batch_size=10, prefetch_buffer=2)
    want = _batches(mx.io.ImageRecordIter(preprocess_threads=1, **kw))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = _batches(mx.io.ImageRecordIter(
            preprocess_threads=2 * (os.cpu_count() or 4) + 1, **kw))
    finally:
        sys.setswitchinterval(old)
    _same(got, want)
