"""Image decode and augmentation.

Counterpart of ``mxnet_tpu/image.py``: ``imdecode``/``imread``, the numpy
resize and crop helpers, the augmenters and ``CreateAugmenter`` (:132-296),
``ImageIter`` (:298), and ``ImageDetIter`` with the detection augmenters
(:421-624). Decoding goes through the port's own decoders (``native``),
chosen by the payload's magic bytes: PNG always, JPEG where the native
library has libjpeg. The JAX package decodes with PIL; PNG is lossless,
so both give the same pixels, and a JPEG here is libjpeg's.

Every helper takes numpy or an NDArray and returns the same kind (an
NDArray on the current context); the resizes are the JAX package's numpy
align-corners bilinear (``gluon/data/vision/transforms._resize_hwc``:
float64 ``linspace`` weights, truncation), copied.
"""
from __future__ import annotations

import os
import random as _pyrandom

import numpy as _np

from . import native
from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["imdecode", "imread", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize", "ImageIter",
           "CreateAugmenter", "Augmenter", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "CenterCropAug", "HorizontalFlipAug", "CastAug",
           "ColorNormalizeAug", "RandomGrayAug", "ImageDetIter",
           "DetAugmenter", "DetHorizontalFlipAug", "DetBorderAug",
           "CreateDetAugmenter"]


def _to_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


def _like(src, out_np):
    """``out_np`` as the kind of container ``src`` is."""
    if isinstance(src, NDArray):
        return nd.array(out_np, dtype=out_np.dtype)
    return out_np


def decode_rgb(buf):
    """An encoded image (PNG, or JPEG with libjpeg) -> (h, w, 3) uint8
    RGB. ValueError for a payload that is neither or is damaged."""
    buf = bytes(buf) if not isinstance(buf, (bytes, bytearray)) else buf
    if native.is_png(buf):
        return native.png_decode(buf)
    if native.is_jpeg(buf):
        return native.jpeg_decode(buf)
    raise ValueError("image payload is neither PNG nor JPEG")


def rgb_to_gray(rgb):
    """PIL's ``convert("L")``: (R 19595 + G 38470 + B 7471 + 2**15) >> 16."""
    rgb = rgb.astype(_np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(_np.uint8)


def _decode_np(buf, flag=1, to_rgb=True):
    rgb = decode_rgb(buf)
    if flag == 0:
        return rgb_to_gray(rgb)[..., None]
    return rgb if to_rgb else _np.ascontiguousarray(rgb[..., ::-1])


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an encoded image to an HWC uint8 NDArray (RGB; BGR with
    ``to_rgb=False``; one gray channel with ``flag=0``)."""
    return nd.array(_decode_np(buf, flag, to_rgb), dtype=_np.uint8)


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def _resize_np(arr, w, h):
    from .gluon.data.vision.transforms import _resize_hwc

    return _resize_hwc(arr, (w, h))


def imresize(src, w, h, interp=1):
    return _like(src, _resize_np(_to_np(src), w, h))


def resize_short(src, size, interp=2):
    """Resize the shorter edge to ``size``."""
    arr = _to_np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    return _like(src, _resize_np(arr, new_w, new_h))


def _crop_np(arr, x0, y0, w, h, size=None):
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = _resize_np(out, size[0], size[1])
    return out


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    return _like(src, _crop_np(_to_np(src), x0, y0, w, h, size))


def center_crop(src, size, interp=2):
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = size
    x0 = int((w - new_w) / 2)
    y0 = int((h - new_h) / 2)
    return _like(src, _crop_np(arr, x0, y0, new_w, new_h)), \
        (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    arr = _to_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = size
    x0 = _pyrandom.randint(0, max(0, w - new_w))
    y0 = _pyrandom.randint(0, max(0, h - new_h))
    return _like(src, _crop_np(arr, x0, y0, new_w, new_h)), \
        (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    arr = _to_np(src).astype(_np.float32)
    if mean is not None:
        arr = arr - _to_np(mean)
    if std is not None:
        arr = arr / _to_np(std)
    return _like(src, arr)


class Augmenter:
    """Base augmenter: numpy in, numpy out; NDArray in, NDArray out."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__.lower(),
                           {k: v for k, v in self._kwargs.items()
                            if isinstance(v, (int, float, str, list, tuple,
                                              bool, type(None)))}])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return _like(src, _to_np(src)[:, ::-1].copy())
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        if isinstance(src, NDArray):
            return src.astype(self.typ)
        return _np.asarray(src, dtype=self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = None if mean is None else _np.asarray(_to_np(mean),
                                                          _np.float32)
        self.std = None if std is None else _np.asarray(_to_np(std),
                                                        _np.float32)

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            arr = _to_np(src)
            gray = arr.astype(_np.float32) @ _np.array([0.299, 0.587, 0.114],
                                                       _np.float32)
            return _like(src, _np.repeat(gray[..., None], 3,
                                         axis=-1).astype(arr.dtype))
        return src


class _JitterAug(Augmenter):
    """A gluon vision transform as an Augmenter (numpy in, numpy out)."""

    def __init__(self, transform, **kwargs):
        super().__init__(**kwargs)
        self._t = transform

    def __call__(self, src):
        out = self._t(nd.array(_to_np(src)) if not isinstance(src, NDArray)
                      else src)
        return _to_np(out) if not isinstance(src, NDArray) else out


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """The standard augmenter list (resize, crop, mirror, cast, color
    jitter, hue, PCA lighting, gray, normalisation)."""
    from .gluon.data.vision import transforms as T

    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        if not rand_crop:
            raise ValueError("rand_resize needs rand_crop")
        auglist.append(_JitterAug(T.RandomResizedCrop(
            (crop_size[0], crop_size[1]))))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(_JitterAug(T.ColorJitter(brightness, contrast,
                                                saturation)))
    if hue:
        auglist.append(_JitterAug(T.RandomHue(hue)))
    if pca_noise > 0:
        auglist.append(_JitterAug(T.RandomLighting(pca_noise)))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Image iterator over a ``.rec`` file or a ``.lst`` list and a
    folder, in Python. The last partial batch is padded with samples from
    the batch's start and ``pad`` counts them."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, data_name="data",
                 label_name="softmax_label", **kwargs):
        from .io import DataDesc

        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._shuffle = shuffle
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape)
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape,
                                      _np.float32)]
        self.provide_label = [DataDesc(label_name, (batch_size, label_width),
                                       _np.float32)]
        self.imgrec = None
        self.imglist = None
        if path_imgrec:
            from . import recordio

            idx_path = path_imgrec[:path_imgrec.rfind(".")] + ".idx"
            self.imgrec = recordio.MXIndexedRecordIO(idx_path, path_imgrec,
                                                     "r")
            self.seq = list(self.imgrec.keys)
        elif path_imglist:
            self.imglist = {}
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = _np.asarray(parts[1:-1], dtype=_np.float32)
                    self.imglist[int(parts[0])] = (label, parts[-1])
            self.seq = list(self.imglist.keys())
            self.path_root = path_root
        else:
            raise ValueError("Either path_imgrec or path_imglist is required")
        self.cur = 0
        self.reset()

    def reset(self):
        if self._shuffle:
            _pyrandom.shuffle(self.seq)
        self.cur = 0

    def next_sample(self):
        """``(label, HWC RGB numpy image)`` of the next sample."""
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            from . import recordio

            header, img_bytes = recordio.unpack(self.imgrec.read_idx(idx))
            return header.label, _decode_np(img_bytes)
        label, fname = self.imglist[idx]
        with open(os.path.join(self.path_root, fname), "rb") as f:
            return label, _decode_np(f.read())

    def _empty_label_batch(self):
        return _np.zeros((self.batch_size, self.label_width), _np.float32)

    def _process_sample(self, arr, label):
        """Augment one sample: ``(HWC image, its label row)``."""
        for aug in self.auglist:
            arr = aug(arr)
        return arr, label

    def next(self):
        from .io import DataBatch

        c, h, w = self.data_shape
        batch_data = _np.zeros((self.batch_size, h, w, c), _np.float32)
        batch_label = self._empty_label_batch()
        i = 0
        while i < self.batch_size:
            try:
                label, arr = self.next_sample()
            except StopIteration:
                if i == 0:
                    raise
                break
            arr, label = self._process_sample(arr, label)
            arr = _to_np(arr)
            if arr.shape[:2] != (h, w):
                arr = _resize_np(arr, w, h)
            batch_data[i] = arr.astype(_np.float32)
            batch_label[i] = label
            i += 1
        pad = self.batch_size - i
        for j in range(pad):
            batch_data[i + j] = batch_data[j % max(i, 1)]
            batch_label[i + j] = batch_label[j % max(i, 1)]
        data = nd.array(batch_data.transpose(0, 3, 1, 2))
        label = nd.array(batch_label)
        return DataBatch(data=[data], label=[label], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()


# ----------------------------------------------------- object detection --

class DetAugmenter:
    """Transforms an image and its boxes together."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetHorizontalFlipAug(DetAugmenter):
    """Flip the image and its normalised boxes with probability ``p``."""

    def __init__(self, p):
        self.p = p

    def __call__(self, src, label):
        if _pyrandom.random() < self.p:
            src = _to_np(src)[:, ::-1]
            label = label.copy()
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1
        return src, label


class DetBorderAug(DetAugmenter):
    """Pad to a square canvas with probability ``p``, moving the boxes."""

    def __init__(self, fill=127, p=1.0):
        self.fill = fill
        self.p = p

    def __call__(self, src, label):
        if _pyrandom.random() >= self.p:
            return src, label
        arr = _to_np(src)
        h, w = arr.shape[:2]
        s = max(h, w)
        if h == w:
            return src, label
        out = _np.full((s, s, arr.shape[2]), self.fill, arr.dtype)
        y0, x0 = (s - h) // 2, (s - w) // 2
        out[y0:y0 + h, x0:x0 + w] = arr
        label = label.copy()
        valid = label[:, 0] >= 0
        label[valid, 1] = (label[valid, 1] * w + x0) / s
        label[valid, 3] = (label[valid, 3] * w + x0) / s
        label[valid, 2] = (label[valid, 2] * h + y0) / s
        label[valid, 4] = (label[valid, 4] * h + y0) / s
        return out, label


class _DetImageAug(DetAugmenter):
    """An image-only augmenter that keeps the geometry (resize, cast,
    normalise) in a detection pipeline."""

    def __init__(self, aug):
        self.aug = aug

    def __call__(self, src, label):
        return self.aug(src), label


def CreateDetAugmenter(data_shape, resize=0, rand_mirror=False, mean=None,
                       std=None, fill=127, rand_pad=0, **kwargs):
    """The detection augmenter list: resize, square padding, flip, cast,
    normalisation. Other arguments raise."""
    if kwargs:
        raise ValueError(
            f"unsupported CreateDetAugmenter arguments {sorted(kwargs)}; "
            "supported: resize, rand_mirror, mean, std, fill, rand_pad")
    auglist = []
    if resize > 0:
        auglist.append(_DetImageAug(ResizeAug(resize)))
    if rand_pad > 0:
        auglist.append(DetBorderAug(fill, p=rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(_DetImageAug(CastAug()))
    if mean is not None or std is not None:
        if mean is True:
            mean = _np.array([123.68, 116.28, 103.53])
        if std is True:
            std = _np.array([58.395, 57.12, 57.375])
        auglist.append(_DetImageAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: each image's boxes padded to a fixed
    ``(max_objects, width)`` label, filler rows with class -1. A label is
    flat ``[cls, xmin, ymin, xmax, ymax] * k`` (normalised) or MXNet's
    packed ``[header_width, object_width, ..., objects...]``."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, data_name="data", label_name="label",
                 label_shape=None, **kwargs):
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, shuffle=shuffle,
                         aug_list=aug_list if aug_list is not None
                         else CreateDetAugmenter(data_shape),
                         data_name=data_name, label_name=label_name,
                         **kwargs)
        from .io import DataDesc

        if label_shape is None:
            label_shape = self._discover_label_shape()
        self.label_shape = tuple(label_shape)
        self.provide_label = [DataDesc(
            label_name, (batch_size,) + self.label_shape, _np.float32)]

    @staticmethod
    def _parse_label(raw):
        """Flat floats -> a (k, width) array."""
        raw = _np.asarray(raw, _np.float32).ravel()
        if raw.size >= 2 and float(raw[0]).is_integer() and \
                float(raw[1]).is_integer() and 2 <= raw[1] <= 32 and \
                raw[0] >= 2 and (raw.size - raw[0]) % raw[1] == 0:
            header, width = int(raw[0]), int(raw[1])
            body = raw[header:]
        elif raw.size % 5 == 0:
            width, body = 5, raw
        else:
            raise ValueError(f"cannot parse detection label of size "
                             f"{raw.size}")
        return body.reshape(-1, width)

    def _iter_raw_labels(self):
        """Every label, without decoding an image."""
        if self.imglist is not None:
            for label, _ in self.imglist.values():
                yield label
        else:
            from . import recordio

            for idx in self.seq:
                header, _ = recordio.unpack(self.imgrec.read_idx(idx))
                yield header.label

    def _discover_label_shape(self):
        max_obj, width = 1, 5
        for label in self._iter_raw_labels():
            parsed = self._parse_label(label)
            max_obj = max(max_obj, parsed.shape[0])
            width = max(width, parsed.shape[1])
        return (max_obj, width)

    def reshape(self, data_shape=None, label_shape=None):
        from .io import DataDesc

        if data_shape is not None:
            self.data_shape = tuple(data_shape)
            self.provide_data = [DataDesc(
                self.provide_data[0].name,
                (self.batch_size,) + self.data_shape, _np.float32)]
        if label_shape is not None:
            self.label_shape = tuple(label_shape)
            self.provide_label = [DataDesc(
                self.provide_label[0].name,
                (self.batch_size,) + self.label_shape, _np.float32)]

    def sync_label_shape(self, it, verbose=False):
        """Grow both iterators' label shapes to their elementwise max."""
        if not isinstance(it, ImageDetIter):
            raise TypeError("sync_label_shape takes an ImageDetIter")
        train, val = self.label_shape, it.label_shape
        shape = (max(train[0], val[0]), max(train[1], val[1]))
        self.reshape(label_shape=shape)
        it.reshape(label_shape=shape)
        return it

    def _empty_label_batch(self):
        return _np.full((self.batch_size,) + self.label_shape, -1.0,
                        _np.float32)

    def _process_sample(self, arr, label):
        max_obj, width = self.label_shape
        parsed = self._parse_label(label)
        if parsed.shape[0] > max_obj or parsed.shape[1] > width:
            raise ValueError(
                f"sample label shape {parsed.shape} exceeds label_shape "
                f"{self.label_shape}; pass a larger label_shape (or use "
                "sync_label_shape)")
        full = _np.full((max_obj, width), -1.0, _np.float32)
        full[:parsed.shape[0], :parsed.shape[1]] = parsed
        for aug in self.auglist:
            arr, full = aug(arr, full)
        return arr, full
