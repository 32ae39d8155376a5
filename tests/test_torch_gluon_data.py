"""``gluon.data`` on the CPU: the port's datasets, samplers, DataLoader,
vision transforms and vision datasets against the JAX package's.

Samplers and the random transforms draw from numpy's global generator,
seeded the same for both packages. Integer and host-numpy results are
held bit for bit; the DataLoader's batches and the transforms that are
array ops (ToTensor, Normalize) to float32's 1e-6 relative, 1e-7
absolute (the same division and subtraction in torch and in XLA). The
vision datasets read files made here in the formats of MNIST (idx,
gzipped or not), CIFAR-10/100 (pickles) and image folders; a missing
file raises and nothing downloads."""
import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jT
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import data
from mxnet_tpu_torch.gluon.data.vision import transforms as T

CPU = mx.cpu()
RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with CPU:
        yield


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def test_datasets_match():
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    y = np.arange(8, dtype=np.int32)
    ds, jds = data.ArrayDataset(x, y), jdata.ArrayDataset(x, y)
    assert len(ds) == len(jds) == 8
    for i in range(8):
        assert all(np.array_equal(_np(a), _np(b))
                   for a, b in zip(ds[i], jds[i]))
    t = ds.transform_first(lambda v: v * 2)
    jt = jds.transform_first(lambda v: v * 2)
    assert np.array_equal(t[3][0], jt[3][0]) and t[3][1] == jt[3][1]
    f = ds.filter(lambda s: s[1] % 2 == 0)
    assert len(f) == 4 and f[1][1] == 2
    assert len(ds.take(3)) == 3 and len(ds.take(30)) == 8
    eager = data.SimpleDataset(list(range(5))).transform(lambda v: v + 1,
                                                         lazy=False)
    assert isinstance(eager, data.SimpleDataset) and eager[4] == 5
    with pytest.raises(ValueError, match="same length"):
        data.ArrayDataset(x, y[:3])


def test_record_file_dataset_reads_the_jax_records(tmp_path):
    path = str(tmp_path / "r.rec")
    w = jmx.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(4):
        w.write_idx(i, bytes([i]) * (i + 3))
    w.close()
    ds, jds = data.RecordFileDataset(path), jdata.RecordFileDataset(path)
    assert len(ds) == 4 and [ds[i] for i in range(4)] == \
        [jds[i] for i in range(4)]


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match(last_batch):
    seq = list(data.SequentialSampler(7, start=2))
    assert seq == list(jdata.SequentialSampler(7, start=2))
    np.random.seed(3)
    mine = list(data.RandomSampler(9))
    np.random.seed(3)
    assert mine == list(jdata.RandomSampler(9))
    bs = data.BatchSampler(data.SequentialSampler(10), 4, last_batch)
    jbs = jdata.BatchSampler(jdata.SequentialSampler(10), 4, last_batch)
    for _ in range(2):      # a rollover carries into the second epoch
        assert len(bs) == len(jbs)
        assert list(bs) == list(jbs)
    with pytest.raises(ValueError, match="last_batch"):
        data.BatchSampler(data.SequentialSampler(3), 2, "nope")


def _loader_pairs(**kw):
    x = np.random.RandomState(0).rand(11, 2, 3).astype(np.float32)
    y = np.arange(11, dtype=np.float32)
    np.random.seed(5)
    mine = [[_np(f) for f in b] for b in data.DataLoader(
        data.ArrayDataset(mx.nd.array(x), y), **kw)]
    np.random.seed(5)
    theirs = [[_np(f) for f in b] for b in jdata.DataLoader(
        jdata.ArrayDataset(jmx.nd.array(x), y), **kw)]
    return mine, theirs


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=4, shuffle=True,
                             last_batch="discard"),
    dict(batch_size=3, num_workers=2, last_batch="rollover"),
    dict(batch_size=5, num_workers=3, shuffle=True, prefetch=1)])
def test_dataloader_matches(kw):
    mine, theirs = _loader_pairs(**kw)
    assert len(mine) == len(theirs) > 0
    for a, b in zip(mine, theirs):
        for f, g in zip(a, b):
            assert f.shape == g.shape
            np.testing.assert_allclose(f, g, rtol=RTOL, atol=ATOL)


def test_dataloader_builds_on_the_callers_context_in_its_threads():
    ds = data.SimpleDataset([np.full(3, i, np.float32) for i in range(6)])
    batches = list(data.DataLoader(ds, batch_size=2, num_workers=2))
    assert [b.context for b in batches] == [CPU] * 3
    assert np.array_equal(batches[2].asnumpy(), np.full((2, 3), [[4], [5]]))
    assert len(data.DataLoader(ds, batch_size=4)) == 2
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="pin_memory=True needs"):
            data.DataLoader(ds, batch_size=2, pin_memory=True)
    with pytest.raises(ValueError, match="must not be specified"):
        data.DataLoader(ds, batch_size=2, batch_sampler=data.BatchSampler(
            data.SequentialSampler(6), 2))


def _hwc(seed, h=18, w=22):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


@pytest.mark.parametrize("make", [
    lambda P: P.Resize(12), lambda P: P.Resize((10, 14)),
    lambda P: P.Resize(9, keep_ratio=True), lambda P: P.CenterCrop(8),
    lambda P: P.CenterCrop((30, 30)), lambda P: P.RandomResizedCrop(10),
    lambda P: P.RandomFlipLeftRight(0.7), lambda P: P.RandomFlipTopBottom(),
    lambda P: P.RandomBrightness(0.4), lambda P: P.RandomContrast(0.4),
    lambda P: P.RandomSaturation(0.4), lambda P: P.RandomHue(0.3),
    lambda P: P.RandomLighting(0.2),
    lambda P: P.ColorJitter(0.3, 0.3, 0.3, 0.2),
    lambda P: P.Compose([P.Resize(16), P.RandomFlipLeftRight(),
                         P.ColorJitter(0.2, 0.2)])])
def test_host_transforms_match_bit_for_bit(make):
    t, jt = make(T), make(jT)
    for seed in range(4):
        img = _hwc(seed)
        np.random.seed(seed)
        got = _np(t(mx.nd.array(img)))
        np.random.seed(seed)
        want = _np(jt(jmx.nd.array(img)))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_array_transforms_match():
    img = _hwc(1)
    batch = np.stack([_hwc(2), _hwc(3)])
    for x in (img, batch):
        got = T.ToTensor()(mx.nd.array(x))
        want = jT.ToTensor()(jmx.nd.array(x))
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
        norm = T.Normalize((0.4, 0.5, 0.6), (0.2, 0.25, 0.3))(got)
        jnorm = jT.Normalize((0.4, 0.5, 0.6), (0.2, 0.25, 0.3))(want)
        assert norm.context == CPU
        np.testing.assert_allclose(_np(norm), _np(jnorm), rtol=RTOL,
                                   atol=1e-6)
    cast = T.Cast("float16")(mx.nd.array(img))
    assert np.array_equal(_np(cast), _np(jT.Cast("float16")(
        jmx.nd.array(img))))


def _mnist_files(root, prefix, n, gz):
    rs = np.random.RandomState(n)
    imgs = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    opener, ext = (gzip.open, ".gz") if gz else (open, "")
    with opener(os.path.join(root, f"{prefix}-images-idx3-ubyte{ext}"),
                "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with opener(os.path.join(root, f"{prefix}-labels-idx1-ubyte{ext}"),
                "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _cifar_files(root, names, fine):
    for k, name in enumerate(names):
        rs = np.random.RandomState(k)
        d = {b"data": rs.randint(0, 256, (6, 3072)).astype(np.uint8)}
        if fine:
            d[b"fine_labels"] = list(rs.randint(0, 100, 6))
            d[b"coarse_labels"] = list(rs.randint(0, 20, 6))
        else:
            d[b"labels"] = list(rs.randint(0, 10, 6))
        with open(os.path.join(root, name), "wb") as f:
            pickle.dump(d, f)


def _same_dataset(ds, jds):
    assert len(ds) == len(jds) > 0
    for i in (0, len(ds) - 1):
        (a, la), (b, lb) = ds[i], jds[i]
        assert np.array_equal(_np(a), _np(b)) and la == lb


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_datasets_read_local_files(tmp_path, gz):
    _mnist_files(str(tmp_path), "train", 7, gz)
    _mnist_files(str(tmp_path), "t10k", 4, gz)
    V, jV = data.vision, jdata.vision
    for cls in ("MNIST", "FashionMNIST"):
        for train in (True, False):
            _same_dataset(getattr(V, cls)(str(tmp_path), train=train),
                          getattr(jV, cls)(str(tmp_path), train=train))
    ds = V.MNIST(str(tmp_path), transform=lambda x, y: (x, y + 1))
    assert ds[0][1] == jV.MNIST(str(tmp_path))[0][1] + 1
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        V.MNIST(str(tmp_path / "none"))


def test_cifar_datasets_read_local_files(tmp_path):
    c10 = tmp_path / "c10" / "cifar-10-batches-py"
    c10.mkdir(parents=True)
    _cifar_files(str(c10), [f"data_batch_{i}" for i in range(1, 6)]
                 + ["test_batch"], fine=False)
    c100 = tmp_path / "c100"
    c100.mkdir()
    _cifar_files(str(c100), ["train", "test"], fine=True)
    V, jV = data.vision, jdata.vision
    for train in (True, False):
        _same_dataset(V.CIFAR10(str(tmp_path / "c10"), train=train),
                      jV.CIFAR10(str(tmp_path / "c10"), train=train))
        for fine in (True, False):
            _same_dataset(V.CIFAR100(str(c100), fine_label=fine,
                                     train=train),
                          jV.CIFAR100(str(c100), fine_label=fine,
                                      train=train))
    with pytest.raises(FileNotFoundError):
        V.CIFAR10(str(tmp_path / "none"))


def test_image_folder_dataset_matches(tmp_path):
    for k, cls in enumerate(("cat", "dog")):
        (tmp_path / cls).mkdir()
        for i in range(2):
            Image.fromarray(_hwc(10 * k + i, 9, 11)).save(
                str(tmp_path / cls / f"{i}.png"))
        np.save(str(tmp_path / cls / "extra.npy"), _hwc(k, 4, 4))
    (tmp_path / "notes.txt").write_text("not a class")
    ds = data.vision.ImageFolderDataset(str(tmp_path))
    jds = jdata.vision.ImageFolderDataset(str(tmp_path))
    assert ds.synsets == jds.synsets == ["cat", "dog"]
    assert [p for p, _ in ds.items] == [p for p, _ in jds.items]
    for i in range(len(ds)):
        (a, la), (b, lb) = ds[i], jds[i]
        assert la == lb and np.array_equal(_np(a), _np(b))
