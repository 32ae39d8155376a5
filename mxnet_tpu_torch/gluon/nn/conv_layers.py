"""Gluon convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``_Conv`` with
Conv1D, Conv2D and Conv3D (:27-122), which infer ``in_channels`` at the
first forward, and ``_Pooling`` with the max, average, global max and
global average pooling layers in 1-D, 2-D and 3-D (:162-270), over the
``Convolution`` and ``Pooling`` ops. Layouts are channels first. The
transposed convolutions (``Conv1DTranspose`` to ``Conv3DTranspose``, the
``Deconvolution`` op) and ``ReflectionPad2D`` are not ported yet: they
raise :class:`MXNetError` when constructed.
"""
from __future__ import annotations

from ...base import MXNetError
from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _pair(val, n):
    if isinstance(val, (list, tuple)):
        if len(val) != n:
            raise ValueError(f"expected {n} values, got {val!r}")
        return tuple(val)
    return (val,) * n


def _channels_first(layout, want):
    if layout != want:
        raise MXNetError(f"layout {layout!r} is not ported (only {want!r}, "
                         "channels first)")


class _Conv(HybridBlock):
    """Convolution with weight ``(channels, in_channels // groups,
    *kernel)`` and an optional bias; ``in_channels=0`` defers the weight's
    second dim to the first forward."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, in_channels, activation, use_bias,
                 weight_initializer, bias_initializer, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        ndim = len(kernel_size)
        self._channels = channels
        self._in_channels = in_channels
        self._kwargs = {
            "kernel": kernel_size, "stride": _pair(strides, ndim),
            "dilate": _pair(dilation, ndim), "pad": _pair(padding, ndim),
            "num_filter": channels, "num_group": groups,
        }
        self._act_type = activation
        wshape = (channels, in_channels // groups if in_channels else 0) \
            + kernel_size
        with self.name_scope():
            self.weight = self.params.get("weight", shape=wshape,
                                          init=weight_initializer,
                                          allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get("bias", shape=(channels,),
                                            init=bias_initializer,
                                            allow_deferred_init=True)
            else:
                self.bias = None

    def infer_shape(self, x, *args):
        w = list(self.weight.shape)
        w[1] = x.shape[1] // self._kwargs["num_group"]
        self.weight.shape = tuple(w)

    def hybrid_forward(self, F, x, weight=None, bias=None):
        if bias is None:
            out = F.Convolution(x, weight, no_bias=True, **self._kwargs)
        else:
            out = F.Convolution(x, weight, bias, **self._kwargs)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out

    def __repr__(self):
        return (f"{type(self).__name__}({self._channels}, "
                f"kernel_size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']})")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        _channels_first(layout, "NCW")
        super().__init__(channels, _pair(kernel_size, 1), strides, padding,
                         dilation, groups, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        _channels_first(layout, "NCHW")
        super().__init__(channels, _pair(kernel_size, 2), strides, padding,
                         dilation, groups, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        _channels_first(layout, "NCDHW")
        super().__init__(channels, _pair(kernel_size, 3), strides, padding,
                         dilation, groups, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


def _not_ported(name, what):
    def __init__(self, *args, **kwargs):
        raise MXNetError(f"{name} ({what}) is not ported to "
                         "mxnet_tpu_torch yet; see ROADMAP.md section A")

    return type(name, (HybridBlock,), {
        "__init__": __init__,
        "__doc__": f"Not ported yet ({what}); raises MXNetError."})


Conv1DTranspose = _not_ported("Conv1DTranspose", "the Deconvolution op")
Conv2DTranspose = _not_ported("Conv2DTranspose", "the Deconvolution op")
Conv3DTranspose = _not_ported("Conv3DTranspose", "the Deconvolution op")
ReflectionPad2D = _not_ported("ReflectionPad2D", "the pad op")


class _Pooling(HybridBlock):
    """Pooling over ``pool_size`` windows; ``ceil_mode`` takes the
    ``full`` convention, else ``valid``."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": _pair(strides, len(pool_size)),
            "pad": _pair(padding, len(pool_size)), "pool_type": pool_type,
            "global_pool": global_pool,
            "pooling_convention": "full" if ceil_mode else "valid",
        }
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)

    def __repr__(self):
        return (f"{type(self).__name__}(size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}, "
                f"padding={self._kwargs['pad']})")


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        _channels_first(layout, "NCW")
        super().__init__(_pair(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        _channels_first(layout, "NCHW")
        super().__init__(_pair(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        _channels_first(layout, "NCDHW")
        super().__init__(_pair(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        _channels_first(layout, "NCW")
        super().__init__(_pair(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        _channels_first(layout, "NCHW")
        super().__init__(_pair(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        _channels_first(layout, "NCDHW")
        super().__init__(_pair(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", count_include_pad, **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, True, True, "max", **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, True, "max", **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, True, True, "max", **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__((1,), None, 0, True, True, "avg", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, 0, True, True, "avg", **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__((1, 1, 1), None, 0, True, True, "avg", **kwargs)
