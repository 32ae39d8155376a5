"""``mx.image`` on the CPU: the port's decoders, helpers, augmenters,
``ImageIter`` and ``ImageDetIter`` against the JAX package's.

PNG decodes equal the JAX package's (PIL) bit for bit; a JPEG decode
equals the JAX package's native libjpeg decode (its ``imdecode`` uses
PIL's bundled libjpeg, another decoder). The resizes and crops are the
JAX package's numpy align-corners code, copied, and held bit for bit;
the random augmenters draw from Python's and numpy's global generators,
seeded the same for both packages."""
import io
import os
import random

import numpy as np
import pytest
from PIL import Image

import mxnet_tpu as jmx
import mxnet_tpu.native as jnative
import mxnet_tpu_torch as mx
from mxnet_tpu import image as jimage
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import image

CPU = mx.cpu()


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with CPU:
        yield


def _img(seed, h=21, w=29):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)


def _png(arr, mode=None):
    buf = io.BytesIO()
    im = Image.fromarray(arr)
    if mode == "P":
        im = im.quantize(colors=64)
    elif mode:
        im = im.convert(mode)
    im.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", [None, "RGBA", "L", "LA", "P"])
@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_png_matches_the_jax_package(mode, flag, to_rgb):
    buf = _png(_img(1), mode)
    got = image.imdecode(buf, flag=flag, to_rgb=to_rgb)
    want = jimage.imdecode(buf, flag=flag, to_rgb=to_rgb)
    assert got.context == CPU and got.asnumpy().dtype == np.uint8
    assert np.array_equal(got.asnumpy(), want.asnumpy())


def test_imdecode_jpeg_is_the_native_libjpeg_decode(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(_img(2, 30, 40)).save(buf, format="JPEG", quality=90)
    raw, _ = jnative.decode_jpeg_batch([buf.getvalue()], 30, 40)
    assert np.array_equal(image.imdecode(buf.getvalue()).asnumpy(), raw[0])
    assert np.array_equal(image.imdecode(buf.getvalue(), to_rgb=False)
                          .asnumpy(), raw[0][..., ::-1])
    path = str(tmp_path / "a.jpg")
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    assert np.array_equal(image.imread(path).asnumpy(), raw[0])
    with pytest.raises(ValueError, match="neither PNG nor JPEG"):
        image.imdecode(b"GIF89a....")


def test_helpers_match_the_jax_package():
    arr = _img(3, 33, 47)
    for fn, args in ((image.imresize, (20, 11)), (image.resize_short, (24,)),
                     (image.fixed_crop, (3, 4, 20, 15)),
                     (image.fixed_crop, (3, 4, 20, 15, (9, 13)))):
        jfn = getattr(jimage, fn.__name__)
        want = jfn(arr, *args)
        assert np.array_equal(fn(arr, *args), want)
        got = fn(mx.nd.array(arr), *args)
        assert isinstance(got, mx.nd.NDArray)
        assert np.array_equal(got.asnumpy(), want)
    (c, box), (jc, jbox) = image.center_crop(arr, (20, 16)), \
        jimage.center_crop(arr, (20, 16))
    assert box == jbox and np.array_equal(c, jc)
    random.seed(4)
    (r, box) = image.random_crop(arr, (20, 16))
    random.seed(4)
    (jr, jbox) = jimage.random_crop(arr, (20, 16))
    assert box == jbox and np.array_equal(r, jr)
    mean, std = np.array([120., 110., 100.]), np.array([50., 60., 70.])
    assert np.array_equal(image.color_normalize(arr, mean, std),
                          jimage.color_normalize(arr, mean, std))


@pytest.mark.parametrize("kw", [
    {}, {"resize": 40, "rand_crop": True, "rand_mirror": True},
    {"rand_crop": True, "rand_resize": True, "mean": True, "std": True},
    {"brightness": 0.3, "contrast": 0.3, "saturation": 0.3, "hue": 0.2,
     "pca_noise": 0.1, "rand_gray": 0.5}])
def test_create_augmenter_pipelines_match(kw):
    auglist = image.CreateAugmenter((3, 24, 24), **kw)
    jauglist = jimage.CreateAugmenter((3, 24, 24), **kw)
    assert [type(a).__name__ for a in auglist] == \
        [type(a).__name__ for a in jauglist]
    for seed in range(3):
        x = y = _img(seed, 36, 44)
        random.seed(seed)
        np.random.seed(seed)
        for a in auglist:
            x = a(x)
        random.seed(seed)
        np.random.seed(seed)
        for a in jauglist:
            y = a(y)
        assert x.dtype == y.dtype
        assert np.array_equal(x, y)
    assert auglist[0].dumps() == jauglist[0].dumps()


def _write_rec(path, n, seed=0, det=False):
    rs = np.random.RandomState(seed)
    w = jrec.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        h, ww = rs.randint(20, 40, 2)
        label = rs.rand(rs.randint(1, 4) * 5).astype(np.float32) if det \
            else float(i % 5)
        if det:
            label[0::5] = rs.randint(0, 3, len(label) // 5)
        w.write_idx(i, jrec.pack_img((0, label, i, 0), rs.randint(
            0, 256, (h, ww, 3)).astype(np.uint8), img_fmt=".png"))
    w.close()


@pytest.mark.parametrize("shuffle", [False, True])
def test_image_iter_over_records_matches(tmp_path, shuffle):
    path = str(tmp_path / "a.rec")
    _write_rec(path, 11)
    kw = dict(batch_size=4, data_shape=(3, 16, 16), path_imgrec=path,
              shuffle=shuffle)
    random.seed(0)
    np.random.seed(0)
    it = image.ImageIter(aug_list=image.CreateAugmenter(
        (3, 16, 16), rand_crop=True, rand_mirror=True), **kw)
    got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]
    random.seed(0)
    np.random.seed(0)
    jit = jimage.ImageIter(aug_list=jimage.CreateAugmenter(
        (3, 16, 16), rand_crop=True, rand_mirror=True), **kw)
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in jit]
    assert [g[2] for g in got] == [w[2] for w in want] == [0, 0, 1]
    for (a, b, _), (c, d, _) in zip(got, want):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    assert it.provide_data == jit.provide_data


def test_image_iter_over_a_list_and_folder_matches(tmp_path):
    lines = []
    for i in range(5):
        name = f"im{i}.png"
        Image.fromarray(_img(i, 18, 22)).save(str(tmp_path / name))
        lines.append(f"{i}\t{i % 2}.0\t{name}\n")
    lst = str(tmp_path / "a.lst")
    with open(lst, "w") as f:
        f.writelines(lines)
    kw = dict(batch_size=2, data_shape=(3, 16, 16), path_imglist=lst,
              path_root=str(tmp_path))
    got = [b.data[0].asnumpy() for b in image.ImageIter(**kw)]
    want = [b.data[0].asnumpy() for b in jimage.ImageIter(**kw)]
    assert len(got) == len(want) == 3
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="path_imgrec or path_imglist"):
        image.ImageIter(2, (3, 8, 8))


@pytest.mark.parametrize("rand_pad", [0, 1.0])
def test_image_det_iter_matches(tmp_path, rand_pad):
    path = str(tmp_path / "d.rec")
    _write_rec(path, 7, seed=2, det=True)
    kw = dict(batch_size=3, data_shape=(3, 20, 20), path_imgrec=path)
    random.seed(1)
    it = image.ImageDetIter(aug_list=image.CreateDetAugmenter(
        (3, 20, 20), rand_mirror=True, rand_pad=rand_pad, mean=True,
        std=True), **kw)
    got = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
    random.seed(1)
    jit = jimage.ImageDetIter(aug_list=jimage.CreateDetAugmenter(
        (3, 20, 20), rand_mirror=True, rand_pad=rand_pad, mean=True,
        std=True), **kw)
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in jit]
    assert it.label_shape == jit.label_shape
    assert len(got) == len(want) == 3
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-5)
        assert np.array_equal(b, d)
    other = image.ImageDetIter(label_shape=(5, 6), **kw)
    it.sync_label_shape(other)
    assert it.label_shape == other.label_shape == (5, 6)
    with pytest.raises(ValueError, match="unsupported CreateDetAugmenter"):
        image.CreateDetAugmenter((3, 8, 8), rand_crop=0.5)
    assert image.ImageDetIter._parse_label([2, 5, 1, .1, .1, .5, .5]).shape \
        == (1, 5)


def test_image_record_dataset_and_gray_decode(tmp_path):
    path = str(tmp_path / "g.rec")
    _write_rec(path, 3)
    ds = mx.gluon.data.vision.ImageRecordDataset(path, flag=0)
    jds = jmx.gluon.data.vision.ImageRecordDataset(path, flag=0)
    for i in range(3):
        (a, la), (b, lb) = ds[i], jds[i]
        assert a.shape[-1] == 1 and la == lb
        assert np.array_equal(a.asnumpy(), b.asnumpy())
    assert os.path.exists(path[:-4] + ".idx")
