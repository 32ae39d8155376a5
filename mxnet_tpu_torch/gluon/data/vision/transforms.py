"""Vision transforms.

Counterpart of ``mxnet_tpu/gluon/data/vision/transforms.py`` (:26-293):
Compose, Cast, ToTensor, Normalize, Resize, CenterCrop,
RandomResizedCrop, RandomFlipLeftRight/TopBottom, RandomBrightness/
Contrast/Saturation/Hue, ColorJitter, RandomLighting. The geometric and
color ones run on the host in numpy with numpy's global generator, as
there, and return an NDArray on the current context; Cast, ToTensor and
Normalize are array ops on the input's device.
"""
from __future__ import annotations

import numpy as _np

from .... import ndarray as nd
from ....ndarray import NDArray
from ... import nn
from ...block import Block, HybridBlock

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomLighting", "ColorJitter"]


def _host(x):
    return x.asnumpy() if isinstance(x, NDArray) else _np.asarray(x)


class Compose(nn.Sequential):
    """Transforms applied in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.invoke("Cast", x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 in [0, 255] -> CHW float32 in [0, 1] (NHWC -> NCHW)."""

    def hybrid_forward(self, F, x):
        x = F.invoke("Cast", x, dtype="float32") / 255.0
        if x.ndim == 3:
            return x.transpose((2, 0, 1))
        return x.transpose((0, 3, 1, 2))


class Normalize(HybridBlock):
    """``(x - mean) / std`` per channel of CHW (or NCHW) input."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean_np = _np.asarray(mean, dtype=_np.float32).reshape(-1, 1, 1)
        self._std_np = _np.asarray(std, dtype=_np.float32).reshape(-1, 1, 1)
        self._consts = {}   # context -> (mean, std), built once each

    def hybrid_forward(self, F, x):
        ctx = x.context
        if ctx not in self._consts:
            self._consts[ctx] = (nd.array(self._mean_np, ctx=ctx),
                                 nd.array(self._std_np, ctx=ctx))
        mean, std = self._consts[ctx]
        if x.ndim == 4:
            mean = mean.expand_dims(0)
            std = std.expand_dims(0)
        return (x - mean) / std


def _resize_hwc(img_np, size, interp="bilinear"):
    """Align-corners bilinear resize of an HWC host array: float64
    ``linspace`` positions, the result truncated to the input's dtype."""
    if isinstance(size, int):
        size = (size, size)
    w, h = size  # (width, height), as MXNet
    src_h, src_w = img_np.shape[:2]
    ys = _np.linspace(0, src_h - 1, h)
    xs = _np.linspace(0, src_w - 1, w)
    y0 = _np.floor(ys).astype(int)
    x0 = _np.floor(xs).astype(int)
    y1 = _np.minimum(y0 + 1, src_h - 1)
    x1 = _np.minimum(x0 + 1, src_w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img = img_np.astype(_np.float32)
    out = (img[y0][:, x0] * (1 - wy) * (1 - wx)
           + img[y0][:, x1] * (1 - wy) * wx
           + img[y1][:, x0] * wy * (1 - wx)
           + img[y1][:, x1] * wy * wx)
    return out.astype(img_np.dtype)


class Resize(Block):
    """Resize HWC input to ``size`` (w, h), or its shorter edge to
    ``size`` with ``keep_ratio``."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    def forward(self, x):
        img = _host(x)
        size = self._size
        if self._keep and isinstance(self._size, int):
            h, w = img.shape[:2]
            if h < w:
                size = (int(w * self._size / h), self._size)
            else:
                size = (self._size, int(h * self._size / w))
        out = _resize_hwc(img, size)
        return nd.array(out, dtype=out.dtype)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size

    def forward(self, x):
        img = _host(x)
        w, h = self._size
        src_h, src_w = img.shape[:2]
        if src_h < h or src_w < w:
            img = _resize_hwc(img, (max(w, src_w), max(h, src_h)))
            src_h, src_w = img.shape[:2]
        y0 = (src_h - h) // 2
        x0 = (src_w - w) // 2
        return nd.array(img[y0:y0 + h, x0:x0 + w], dtype=img.dtype)


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        if isinstance(size, int):
            size = (size, size)
        self._size = size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        img = _host(x)
        src_h, src_w = img.shape[:2]
        area = src_h * src_w
        for _ in range(10):
            target_area = _np.random.uniform(*self._scale) * area
            aspect = _np.random.uniform(*self._ratio)
            w = int(round(_np.sqrt(target_area * aspect)))
            h = int(round(_np.sqrt(target_area / aspect)))
            if w <= src_w and h <= src_h:
                x0 = _np.random.randint(0, src_w - w + 1)
                y0 = _np.random.randint(0, src_h - h + 1)
                crop = img[y0:y0 + h, x0:x0 + w]
                return nd.array(_resize_hwc(crop, self._size),
                                dtype=img.dtype)
        return CenterCrop(self._size).forward(img)


class _RandomFlip(Block):
    _axis = 1

    def __init__(self, p=0.5):
        super().__init__()
        self._p = p

    def forward(self, x):
        if _np.random.rand() < self._p:
            img = _host(x)
            return nd.array(_np.flip(img, self._axis).copy(), dtype=img.dtype)
        return x if isinstance(x, NDArray) else nd.array(x)


class RandomFlipLeftRight(_RandomFlip):
    _axis = 1


class RandomFlipTopBottom(_RandomFlip):
    _axis = 0


class _RandomColor(Block):
    def __init__(self, change):
        super().__init__()
        self._change = change

    def _alpha(self):
        return 1.0 + _np.random.uniform(-self._change, self._change)

    @staticmethod
    def _clipped(out, img):
        out = _np.clip(out, 0, 255 if img.dtype == _np.uint8 else _np.inf)
        return nd.array(out.astype(img.dtype), dtype=img.dtype)


class RandomBrightness(_RandomColor):
    def forward(self, x):
        img = _host(x)
        return self._clipped(img.astype(_np.float32) * self._alpha(), img)


class RandomContrast(_RandomColor):
    def forward(self, x):
        img = _host(x)
        alpha = self._alpha()
        gray = img.astype(_np.float32).mean()
        return self._clipped(img.astype(_np.float32) * alpha
                             + gray * (1 - alpha), img)


class RandomSaturation(_RandomColor):
    def forward(self, x):
        img = _host(x)
        alpha = self._alpha()
        gray = img.astype(_np.float32).mean(axis=-1, keepdims=True)
        return self._clipped(img.astype(_np.float32) * alpha
                             + gray * (1 - alpha), img)


class RandomHue(_RandomColor):
    """Rotate the hue by U(-hue, hue) through the YIQ rotation matrix."""

    def forward(self, x):
        img = _host(x)
        alpha = _np.random.uniform(-self._change, self._change)
        u = _np.cos(alpha * _np.pi)
        w = _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]])
        tyiq = _np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]])
        ityiq = _np.array([[1.0, 0.95617, 0.62143],
                           [1.0, -0.27269, -0.64681],
                           [1.0, -1.10744, 1.70062]])
        t = ityiq @ bt @ tyiq
        out = img.astype(_np.float32) @ t.T.astype(_np.float32)
        if img.dtype == _np.uint8:
            out = _np.clip(out, 0, 255)
        return nd.array(out.astype(img.dtype), dtype=img.dtype)


class RandomLighting(Block):
    """AlexNet's PCA lighting noise."""

    _eigval = _np.array([55.46, 4.794, 1.148])
    _eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]])

    def __init__(self, alpha=0.1):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        img = _host(x)
        alpha = _np.random.normal(0, self._alpha, 3)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        out = img.astype(_np.float32) + rgb
        if img.dtype == _np.uint8:
            out = _np.clip(out, 0, 255)
        return nd.array(out.astype(img.dtype), dtype=img.dtype)


class ColorJitter(Block):
    """Brightness, contrast, saturation and hue jitter in a random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._transforms = []
        if brightness:
            self._transforms.append(RandomBrightness(brightness))
        if contrast:
            self._transforms.append(RandomContrast(contrast))
        if saturation:
            self._transforms.append(RandomSaturation(saturation))
        if hue:
            self._transforms.append(RandomHue(hue))

    def forward(self, x):
        order = _np.random.permutation(len(self._transforms))
        for i in order:
            x = self._transforms[i].forward(x)
        return x
