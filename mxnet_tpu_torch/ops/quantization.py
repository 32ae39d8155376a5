"""Quantization ops: symmetric int8 with int32 accumulation.

Counterpart of ``mxnet_tpu/ops/quantization.py``, all of its names:
``_scale`` :23, ``_quantize`` :29, ``_contrib_quantize`` :34,
``_contrib_quantize_v2`` :42, ``_contrib_dequantize`` :57,
``_contrib_requantize`` :64, ``_contrib_quantized_fully_connected`` :81,
``_contrib_quantized_conv`` :121, the tail of (int8, min, max) ops
(``_contrib_quantized_act`` :162, ``_flatten`` :179, ``_concat`` :186,
``_elemwise_add`` :207, ``_elemwise_mul`` :221, ``_pooling`` :235,
``_batch_norm`` :257, ``_embedding`` :280), ``_contrib_quantize_asym``
:297 and ``_contrib_calibrate_entropy`` :314, with the same numbers:

* scale = max(|min_range|, |max_range|) / 127 in float32 (1 for an
  all-zero range), zero point 0;
* quantize = clip(round(x / scale), -127, 127) as int8, with
  round-half-to-even (``torch.round``, as ``jnp.round``);
* a division by a constant divides by a tensor on the operand's device
  (:func:`_div`): PyTorch's CUDA division by a host scalar multiplies by
  its reciprocal, which can differ from the quotient in the last bit;
* the quantized FullyConnected folds the activation scale into the
  weight scale (``s_x * scale``, a float32 product) and hands the int8
  product to the kernel family ``int8_gemm`` (``kernels/int8_gemm.py``):
  the hand-written CUDA kernel on a card, its plain version on the CPU.
  The JAX op sends only 2-D data there and computes 3-D data with
  ``dot_general``; both are the same exact int32 product and the same
  float32 epilogue, so here every case goes to the family, with the
  leading dims of 3-D data flattened into rows;
* the quantized convolution is an XLA int8 convolution in the JAX
  package; torch has no int8 convolution on a card, so it is lowered to
  the same family: an int8 im2col (:func:`_im2col`) and one ``int8_gemm``
  per group, with ``s_x * scale`` and the bias in its epilogue, in the
  JAX op's order (``acc * (s_x * scale) + bias``). The int32 sums are
  exact either way, so the result is the JAX op's bit for bit.
"""
from __future__ import annotations

import math

import numpy as _np
import torch
import torch.nn.functional as F

from ..kernels import dispatch
from .nn import _tuplize
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


def _div(a, value):
    """``a / value`` for a Python number ``value``, as a true division on
    ``a``'s device (see the module docstring)."""
    return a / torch.full((), value, dtype=a.dtype, device=a.device)


def _f32(value, like):
    """A float32 scalar tensor on ``like``'s device, written by a fill."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def _range(data, min_calib_range, max_calib_range):
    """The calibrated range as float32 scalars on ``data``'s device, or
    the data's own min and max (on the device) when it is not given."""
    if min_calib_range is None or max_calib_range is None:
        return data.min().to(torch.float32), data.max().to(torch.float32)
    return _f32(min_calib_range, data), _f32(max_calib_range, data)


def _scale(min_range, max_range):
    s = _div(torch.maximum(min_range.abs(), max_range.abs()), 127.0)
    # all-zero range (dead activation): scale 1 maps everything to q=0
    return torch.where(s > 0, s, torch.ones_like(s))


def _quantize(data, scale):
    return torch.clamp(torch.round(data / scale), -127, 127).to(torch.int8)


def _requantized(out, min_calib_range=None, max_calib_range=None):
    """``(int8, min, max)`` of ``out`` quantized onto the calibrated
    range, or onto its own min and max, taken on the device."""
    min_out, max_out = _range(out, min_calib_range, max_calib_range)
    return _quantize(out, _scale(min_out, max_out)), min_out, max_out


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
    min_r, max_r = _range(data, min_calib_range, max_calib_range)
    s = _scale(min_r, max_r) if min_calib_range is None or \
        max_calib_range is None else \
        _attr_scale(min_calib_range, max_calib_range, data)
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


@register("_contrib_requantize", num_outputs=3)
def _contrib_requantize(data, min_range, max_range, min_calib_range=None,
                        max_calib_range=None):
    """int32 accumulator -> int8 on a new range: the calibrated one, or
    the dequantized values' own min and max (on the device)."""
    in_scale = _div(torch.maximum(min_range.abs(), max_range.abs()),
                    2.0 ** 31 - 1)
    return _requantized(data.to(torch.float32) * in_scale,
                        min_calib_range, max_calib_range)


def _im2col(qx, kernel, stride, dilate, pad):
    """The int8 patches of ``qx`` (N, C, *spatial) as one matrix
    ``(N * prod(out), C * prod(kernel))`` whose columns run ``(c, k...)``,
    the order of ``weight.reshape(F, -1)``, and the output's spatial
    shape. Zero padding, then one strided ``unfold`` view per spatial
    axis (a dilated window is unfolded over its span and sliced every
    ``dilate``-th element), then one copy. A 1x1 unpadded kernel needs
    no patches: its matrix is the channels-last view of the (strided)
    activation, a copy only when the activation is not stored channels
    last."""
    n = len(kernel)
    c = qx.shape[1]
    if all(k == 1 for k in kernel) and not any(pad):
        x = qx[(slice(None), slice(None)) +
               tuple(slice(None, None, s) for s in stride)]
        return x.movedim(1, -1).reshape(-1, c), tuple(x.shape[2:])
    if any(pad):
        qx = F.pad(qx, [p for p in reversed(pad) for _ in (0, 1)])
    x = qx
    for i, (k, s, d) in enumerate(zip(kernel, stride, dilate)):
        x = x.unfold(2 + i, (k - 1) * d + 1, s)
        if d > 1:
            x = x[..., ::d]
    out = tuple(x.shape[2:2 + n])
    perm = (0,) + tuple(range(2, 2 + n)) + (1,) + \
        tuple(range(2 + n, 2 + 2 * n))
    return x.permute(perm).reshape(-1, c * math.prod(kernel)), out


@register("_contrib_quantized_conv")
def _quantized_conv(data, weight, scale, bias=None, kernel=(), stride=(),
                    dilate=(), pad=(), num_filter=1, num_group=1,
                    no_bias=False, layout=None, min_calib_range=0.0,
                    max_calib_range=0.0, min_out_calib_range=None,
                    max_out_calib_range=None):
    """int8 Convolution, channels first (NCW, NCHW, NCDHW).

    ``weight``: int8 ``(num_filter, C / num_group, *kernel)``; ``scale``:
    float32 ``(num_filter,)`` channel-wise or one element tensor-wise.
    The activation is quantized with its calibrated range, its patches
    gathered by :func:`_im2col`, and each group's product is one
    ``int8_gemm`` (K4 on a card) against ``weight.reshape(F, -1)`` (no
    copy) with the folded scale and the bias in the epilogue. A grouped
    convolution takes one launch per group, a depthwise one as many as
    it has channels: correct and slow.

    The result is a ``(N, F, *out)`` view of channels-last memory, the
    product's own rows: the ops that read it in the int8 graphs
    (BatchNorm, the activation, the next layer's quantize, the residual
    add) are per element, and a 1x1 convolution after them takes its
    operand with no copy. A contiguous NCHW copy instead made the int8
    ResNet-50 forward at batch 32 1.35x slower on an H100 (13.85 ms
    against 10.26, ``chip_smoke.py`` phase resnet50_v1_int8). The observed
    output range (``*_out_calib_range``) rides along for exporters."""
    kernel = tuple(weight.shape[2:])
    n = len(kernel)
    stride = _tuplize(stride or 1, n)
    dilate = _tuplize(dilate or 1, n)
    pad = _tuplize(pad or 0, n)
    s_x = _attr_scale(min_calib_range, max_calib_range, data)
    qx = _quantize(data, s_x)
    scale_eff = s_x * scale
    bias = None if (bias is None or no_bias) else bias
    f, g = weight.shape[0], int(num_group)
    cg, fg = qx.shape[1] // g, f // g
    outs = []
    for j in range(g):
        part = qx if g == 1 else qx[:, j * cg:(j + 1) * cg]
        cols, spatial = _im2col(part, kernel, stride, dilate, pad)
        rows = slice(j * fg, (j + 1) * fg)
        outs.append(dispatch(
            "int8_gemm", cols, weight[rows].reshape(fg, -1),
            scale_eff if scale_eff.numel() == 1 else scale_eff[rows],
            bias=None if bias is None else bias[rows]))
    out = outs[0] if g == 1 else torch.cat(outs, dim=1)
    return out.reshape((qx.shape[0],) + spatial + (f,)).movedim(-1, 1)


# ------------------------------------------------- the quantized op tail ---
# (int8 data, min_range, max_range) in, (int8 out, min, max) out

@register("_contrib_quantized_act", num_outputs=3)
def _quantized_act(data, min_data, max_data, act_type="relu"):
    """int8 Activation: relu clips the range to (0, max) and requantizes
    the payload onto the new scale; other types pass through."""
    if act_type != "relu":
        return data, min_data, max_data
    s_in = _scale(min_data, max_data)
    min_out = torch.clamp_min(min_data, 0.0)
    s_out = _scale(min_out, max_data)
    q = torch.clamp_min(data, 0).to(torch.float32) * (s_in / s_out)
    return torch.clamp(torch.round(q), -127, 127).to(torch.int8), \
        min_out, max_data


@register("_contrib_quantized_flatten", num_outputs=3)
def _quantized_flatten(data, min_data, max_data):
    """int8 Flatten: a reshape; the range passes through."""
    return data.reshape(data.shape[0], -1), min_data, max_data


@register("_contrib_quantized_concat", num_outputs=3)
def _quantized_concat(*args, dim=1, num_args=None):
    """``args`` = all data first, then the (min, max) pairs:
    ``[d0, d1, ..., min0, max0, min1, max1, ...]``. Every input is
    requantized onto the widest range before the concatenation."""
    n = len(args) // 3
    datas, mins, maxs = args[:n], args[n::2][:n], args[n + 1::2][:n]
    min_out, max_out = mins[0], maxs[0]
    for m in mins[1:]:
        min_out = torch.minimum(min_out, m)
    for m in maxs[1:]:
        max_out = torch.maximum(max_out, m)
    s_out = _scale(min_out, max_out)
    parts = [_quantize(d.to(torch.float32) * _scale(mn, mx), s_out)
             for d, mn, mx in zip(datas, mins, maxs)]
    return torch.cat(parts, dim=dim), min_out, max_out


@register("_contrib_quantized_elemwise_add", num_outputs=3)
def _quantized_elemwise_add(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    """Both sides dequantized, added in float32, the sum requantized onto
    its own range."""
    out = lhs.to(torch.float32) * _scale(lhs_min, lhs_max) + \
        rhs.to(torch.float32) * _scale(rhs_min, rhs_max)
    return _requantized(out)


@register("_contrib_quantized_elemwise_mul", num_outputs=3)
def _quantized_elemwise_mul(lhs, rhs, lhs_min, lhs_max, rhs_min, rhs_max):
    """Both sides dequantized, multiplied in float32, the product
    requantized onto its own range."""
    out = (lhs.to(torch.float32) * _scale(lhs_min, lhs_max)) * \
        (rhs.to(torch.float32) * _scale(rhs_min, rhs_max))
    return _requantized(out)


@register("_contrib_quantized_pooling", num_outputs=3)
def _quantized_pooling(data, min_data, max_data, kernel=(2, 2),
                       pool_type="max", stride=(1, 1), pad=(0, 0),
                       global_pool=False, pooling_convention="valid"):
    """int8 pooling through the port's ``Pooling`` on the float values of
    the codes: max keeps the int8 order (and its codes), avg is rounded
    back half to even."""
    from .nn import _pooling

    out = _pooling(data.to(torch.float32), kernel=kernel,
                   pool_type=pool_type, stride=stride, pad=pad,
                   global_pool=global_pool,
                   pooling_convention=pooling_convention)
    if pool_type != "max":
        out = torch.clamp(torch.round(out), -127, 127)
    return out.to(torch.int8), min_data, max_data


@register("_contrib_quantized_batch_norm", num_outputs=3)
def _quantized_batch_norm(data, gamma, beta, moving_mean, moving_var,
                          min_data, max_data, eps=1e-3, min_calib_range=None,
                          max_calib_range=None, **kw):
    """Inference BatchNorm on int8: dequantize, normalise with the moving
    statistics in float32, requantize onto the calibrated range (or the
    output's own)."""
    x = data.to(torch.float32) * _scale(min_data, max_data)
    shape = [1, -1] + [1] * (data.ndim - 2)
    inv = gamma / torch.sqrt(moving_var + eps)
    out = (x - moving_mean.reshape(shape)) * inv.reshape(shape) + \
        beta.reshape(shape)
    return _requantized(out, min_calib_range, max_calib_range)


@register("_contrib_quantize_asym", num_outputs=3)
def _quantize_asym(data, min_calib_range=None, max_calib_range=None):
    """Affine quantization: ``(int8 out, scale, shift)`` with ``scale =
    255 / (max - min)`` and ``shift = -min * scale - 128``."""
    min_r, max_r = _range(data, min_calib_range, max_calib_range)
    rng = torch.where(max_r > min_r, max_r - min_r, torch.ones_like(max_r))
    scale = torch.full_like(rng, 255.0) / rng
    shift = -min_r * scale - 128.0
    q = torch.clamp(torch.round(data * scale + shift), -128, 127)
    return q.to(torch.int8), scale, shift


_KL_CANDIDATES = 64


@register("_contrib_calibrate_entropy", num_outputs=2)
def _calibrate_entropy(hist, hist_edges, num_quantized_bins=255):
    """The JAX op's symmetric KL threshold search: each of 64 candidate
    thresholds, ``linspace(abs_max / 64, abs_max, 64)``, clips the
    histogram at the bin centers it covers (the outlier mass spread over
    the bins inside), projects it onto ``num_quantized_bins`` levels and
    back, and scores KL(P || Q); returns ``(-best, best)``. All 64
    candidates run as one batched pass over a ``(64, bins)`` tensor, the
    projection a ``scatter_add`` (JAX's ``segment_sum``), with no host
    sync."""
    nq = int(num_quantized_bins)
    hist_f = hist.to(torch.float32)
    centers = (hist_edges[:-1] + hist_edges[1:]) / 2.0
    abs_max = torch.maximum(hist_edges[0].abs(), hist_edges[-1].abs())
    # jnp.linspace's float32 arithmetic: start * (1 - t) + stop * t, then
    # the end point itself
    div = _KL_CANDIDATES - 1
    t = _div(torch.arange(div, dtype=torch.float32, device=hist.device),
             float(div))
    start = _div(abs_max, float(_KL_CANDIDATES))
    cands = torch.cat([start * (1 - t) + abs_max * t, abs_max[None]])
    th = cands[:, None]
    inside = centers.abs()[None, :] <= th
    p = torch.where(inside, hist_f, torch.zeros_like(hist_f))
    outliers = hist_f.sum() - p.sum(dim=1, keepdim=True)
    n_inside = inside.sum(dim=1, keepdim=True).clamp_min(1).to(torch.float32)
    p = p + torch.where(inside, outliers / n_inside, torch.zeros_like(p))
    bucket = torch.clamp(((centers.abs()[None, :] / torch.clamp_min(
        th, 1e-12)) * (nq - 1)).to(torch.int64), 0, nq - 1)
    zeros = torch.zeros((_KL_CANDIDATES, nq), dtype=torch.float32,
                        device=hist.device)
    q_sum = zeros.scatter_add(1, bucket, p)
    q_cnt = zeros.scatter_add(1, bucket, inside.to(torch.float32))
    q = torch.where(q_cnt > 0, q_sum / torch.clamp_min(q_cnt, 1.0),
                    torch.zeros_like(q_sum)).gather(1, bucket)
    q = torch.where(inside, q, torch.zeros_like(q))
    p_n = p / torch.clamp_min(p.sum(dim=1, keepdim=True), 1e-12)
    q_n = q / torch.clamp_min(q.sum(dim=1, keepdim=True), 1e-12)
    both = (p_n > 0) & (q_n > 0)
    terms = torch.where(both, p_n * torch.log(
        torch.where(both, p_n / q_n, torch.ones_like(p_n))),
        torch.zeros_like(p_n))
    best = cands.index_select(0, torch.argmin(terms.sum(dim=1)).reshape(1))
    best = best.reshape(())
    return -best, best
