"""Quantization ops: symmetric int8 with int32 accumulation.

Counterpart of ``mxnet_tpu/ops/quantization.py``: ``_scale`` :23,
``_quantize`` :29, ``_contrib_quantize`` :34, ``_contrib_quantize_v2``
:42, ``_contrib_dequantize`` :57, ``_contrib_quantized_fully_connected``
:81 and ``_contrib_quantized_embedding`` :280, with the same numbers:

* scale = max(|min_range|, |max_range|) / 127 in float32 (1 for an
  all-zero range), zero point 0;
* quantize = clip(round(x / scale), -127, 127) as int8, with
  round-half-to-even (``torch.round``, as ``jnp.round``);
* the quantized FullyConnected folds the activation scale into the
  weight scale (``s_x * scale``, a float32 product) and hands the int8
  product to the kernel family ``int8_gemm`` (``kernels/int8_gemm.py``):
  the hand-written CUDA kernel on a card, its plain version on the CPU.
  The JAX op sends only 2-D data there and computes 3-D data with
  ``dot_general``; both are the same exact int32 product and the same
  float32 epilogue, so here every case goes to the family, with the
  leading dims of 3-D data flattened into rows.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..kernels import dispatch
from .registry import register

__all__ = []


def _attr_scale(min_range, max_range, like):
    """``_scale`` of two attribute floats as a float32 scalar tensor on
    ``like``'s device. The float32 arithmetic runs on the host (numpy
    rounds each operation as the device does) and the result is written
    by a fill, not copied from the host: a host-to-device copy would make
    the host wait for the device at every quantized layer."""
    s = _np.maximum(_np.abs(_np.float32(min_range)),
                    _np.abs(_np.float32(max_range))) / _np.float32(127.0)
    return torch.full((), float(s if s > 0 else 1.0), dtype=torch.float32,
                      device=like.device)


def _scale(min_range, max_range):
    s = torch.maximum(min_range.abs(), max_range.abs()) / 127.0
    # all-zero range (dead activation): scale 1 maps everything to q=0
    return torch.where(s > 0, s, torch.ones_like(s))


def _quantize(data, scale):
    return torch.clamp(torch.round(data / scale), -127, 127).to(torch.int8)


@register("_contrib_quantize", num_outputs=3)
def _contrib_quantize(data, min_range, max_range, out_type="int8"):
    """float -> int8 with the given ranges."""
    s = _scale(min_range, max_range)
    return _quantize(data, s), min_range.to(torch.float32), \
        max_range.to(torch.float32)


@register("_contrib_quantize_v2", num_outputs=3)
def _contrib_quantize_v2(data, min_calib_range=None, max_calib_range=None,
                         out_type="int8"):
    """Calibrated ranges as attributes, or the batch's own min and max
    when they are not given."""
    if min_calib_range is None or max_calib_range is None:
        min_r = data.min().to(torch.float32)
        max_r = data.max().to(torch.float32)
        s = _scale(min_r, max_r)
    else:
        min_r, max_r = (torch.full((), float(v), dtype=torch.float32,
                                   device=data.device)
                        for v in (min_calib_range, max_calib_range))
        s = _attr_scale(min_calib_range, max_calib_range, data)
    return _quantize(data, s), min_r, max_r


@register("_contrib_dequantize")
def _contrib_dequantize(data, min_range, max_range, out_type="float32"):
    return data.to(torch.float32) * _scale(min_range, max_range)


@register("_contrib_quantized_fully_connected")
def _quantized_fully_connected(data, weight, scale, bias=None, num_hidden=1,
                               no_bias=False, flatten=True,
                               min_calib_range=0.0, max_calib_range=0.0,
                               min_out_calib_range=None,
                               max_out_calib_range=None):
    """int8 FullyConnected: the activation quantized with its calibrated
    range, int8 x int8 -> int32, per-output-channel dequantize.

    ``weight``: int8 (num_hidden, K); ``scale``: float32 weight scales,
    (num_hidden,) channel-wise or one element tensor-wise. The observed
    output range (``*_out_calib_range``) rides along for exporters and
    does not change the result."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    s_x = _attr_scale(min_calib_range, max_calib_range, data)
    qx = _quantize(data, s_x)
    rows = qx.reshape(-1, qx.shape[-1])
    out = dispatch("int8_gemm", rows, weight, s_x * scale,
                   bias=None if (bias is None or no_bias) else bias)
    return out.reshape(qx.shape[:-1] + (weight.shape[0],))


@register("_contrib_quantized_embedding", num_outputs=3)
def _quantized_embedding(data, weight, min_weight, max_weight,
                         input_dim=None, output_dim=None):
    """int8 row gather; the table's range passes through for the
    dequantize that follows. Ids may arrive as floats and are truncated
    to integers, as the JAX op does."""
    return weight[data.to(torch.int64)], min_weight, max_weight
