"""Neural-net ops the serving and training paths use.

Counterpart of ``mxnet_tpu/ops/nn.py`` (FullyConnected :29, Convolution
:60, Pooling :118, _contrib_AdaptiveAvgPooling2D :180, BatchNorm :202,
LayerNorm :226, softmax :283, log_softmax :294, Activation :377,
LeakyReLU :391, Dropout :424, SoftmaxOutput :317-374). These were plain
XLA in the JAX package,
so here they are plain PyTorch (cuBLAS for the matrix products, cuDNN for
convolutions and BatchNorm on the card). Layouts are the JAX package's:
channels first (NCW, NCHW, NCDHW), convolution weights ``(num_filter,
C / num_group, *kernel)``. Dropout takes an explicit ``torch.Generator``
where the JAX op took a PRNG key. Deconvolution is not ported yet.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import register


@register("FullyConnected")
def _fully_connected(data, weight, bias=None, num_hidden=None,
                     no_bias=False, flatten=True):
    """weight is ``(num_hidden, in_units)``, the JAX package's layout."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


def _tuplize(v, n):
    if v is None or v == ():
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution")
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=1, num_group=1, no_bias=False,
                 layout=None, cudnn_off=False, workspace=1024,
                 cudnn_tune=None):
    """1-D, 2-D or 3-D convolution, symmetric zero padding ``pad``."""
    n = len(kernel) if kernel else weight.ndim - 2
    return _CONV[n](data, weight, None if no_bias else bias,
                    _tuplize(stride or 1, n), _tuplize(pad or 0, n),
                    _tuplize(dilate or 1, n), num_group)


def _pool_pads(data, kernel, stride, pad, convention):
    """``[(low, high)]`` per spatial dim, the JAX op's arithmetic
    (``mxnet_tpu/ops/nn.py:134-153``): ``full`` pads the high side up to a
    ceil-mode output, ``same`` splits TF's SAME padding."""
    pads = []
    for i in range(len(kernel)):
        size = data.shape[2 + i]
        if convention == "full":
            out = -(-(size + 2 * pad[i] - kernel[i]) // stride[i]) + 1
            need = (out - 1) * stride[i] + kernel[i] - size - pad[i]
            pads.append((pad[i], max(need, pad[i])))
        elif convention == "same":
            out = -(-size // stride[i])
            need = max((out - 1) * stride[i] + kernel[i] - size, 0)
            pads.append((need // 2, need - need // 2))
        else:
            pads.append((pad[i], pad[i]))
    return pads


def _window_sum(x, kernel, stride):
    """The sum over each window (no padding), for 1-3 spatial dims."""
    n = len(kernel)
    if n == 1:
        return _window_sum(x.unsqueeze(2), (1,) + tuple(kernel),
                           (1,) + tuple(stride)).squeeze(2)
    pool = F.avg_pool2d if n == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@register("Pooling")
def _pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
             global_pool=False, pooling_convention="valid", cudnn_off=False,
             count_include_pad=True, layout=None):
    """Max, average or sum over windows, with the JAX op's padding: max
    pools pad with -inf, average and sum with zeros; ``avg`` divides by
    the window size, or with ``count_include_pad=False`` by the count of
    elements inside the input."""
    n = data.ndim - 2
    spatial = tuple(range(2, data.ndim))
    if global_pool:
        if pool_type == "max":
            return _MAX_POOL[n](data, tuple(data.shape[2:]))
        if pool_type == "avg":
            return data.mean(dim=spatial, keepdim=True)
        if pool_type == "sum":
            return data.sum(dim=spatial, keepdim=True)
    kernel = _tuplize(kernel, n)
    stride = _tuplize(stride or 1, n)
    pad = _tuplize(pad or 0, n)
    pads = _pool_pads(data, kernel, stride, pad, pooling_convention)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad's order
    if pool_type == "max":
        if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
            # the native pad is -inf too
            return _MAX_POOL[n](data, kernel, stride, [lo for lo, _ in pads])
        return _MAX_POOL[n](F.pad(data, flat, value=-math.inf), kernel,
                            stride)
    if pool_type in ("avg", "sum"):
        summed = _window_sum(F.pad(data, flat), kernel, stride)
        if pool_type == "sum":
            return summed
        if count_include_pad:
            return summed / math.prod(kernel)
        ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                          device=data.device)
        return summed / _window_sum(F.pad(ones, flat), kernel, stride)
    if pool_type == "lp":
        raise NotImplementedError("lp pooling")
    raise ValueError(f"unknown pool_type {pool_type}")


@register("_contrib_AdaptiveAvgPooling2D")
def _adaptive_avg_pool2d(data, output_size=(1, 1)):
    """Means over ``output_size`` cells; cell i of a dim of size h spans
    ``[floor(i * h / oh), floor((i + 1) * h / oh))``, the JAX op's bounds
    (PyTorch's adaptive pooling ends cells at the ceiling instead)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    b, c, h, w = data.shape
    oh, ow = output_size
    if h % oh == 0 and w % ow == 0:
        return data.reshape(b, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    hs = [int(i * h / oh) for i in range(oh + 1)]
    ws = [int(j * w / ow) for j in range(ow + 1)]
    x = torch.cat([data[:, :, hs[i]:hs[i + 1], :].mean(dim=2, keepdim=True)
                   for i in range(oh)], dim=2)
    return torch.cat([x[:, :, :, ws[j]:ws[j + 1]].mean(dim=3, keepdim=True)
                      for j in range(ow)], dim=3)


@register("BatchNorm", num_outputs=3)
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                training=True):
    """``(out, batch_mean, batch_var)``; the caller updates the running
    statistics (the JAX op is functional too). In training (and without
    ``use_global_stats``) ``out = (x - mean) * (g * rsqrt(var + eps)) +
    beta`` over the batch's float32 mean and *biased* variance, which the
    op returns; otherwise the moving statistics normalise and are
    returned. ``fix_gamma`` uses ones for ``g`` (gamma gets no gradient;
    a weight of None would send PyTorch's CUDA backward into an undefined
    tensor).

    One ``batch_norm`` call (cuDNN's on the card) normalises and, with
    momentum 1 into fresh buffers, hands back the batch mean and the
    unbiased variance, which is rescaled by ``(n - 1) / n``."""
    axis = axis % data.ndim
    x = data if axis == 1 else data.movedim(axis, 1)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training and not use_global_stats:
        n = x.numel() // x.shape[1]
        mean = torch.zeros(x.shape[1], dtype=torch.float32,
                           device=data.device)
        var = torch.zeros_like(mean)
        out = F.batch_norm(x, mean, var, g, beta, training=True,
                           momentum=1.0, eps=eps)
        var = var * ((n - 1) / n)
    else:
        mean = moving_mean.to(torch.float32)
        var = moving_var.to(torch.float32)
        out = F.batch_norm(x, mean, var, g, beta, training=False, eps=eps)
    out = out if axis == 1 else out.movedim(1, axis)
    return out.to(data.dtype), mean, var


@register("LayerNorm")
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5,
                output_mean_var=False):
    """Normalise over ``axis`` with the biased variance."""
    x = data.movedim(axis, -1)
    out = F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)
    return out.movedim(-1, axis)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


@register("Activation")
def _activation(data, act_type="relu"):
    if act_type not in _ACTIVATIONS:
        raise ValueError(f"unknown Activation act_type {act_type!r}; "
                         f"expected one of {sorted(_ACTIVATIONS)}")
    return _ACTIVATIONS[act_type](data)


@register("LeakyReLU")
def _leaky_relu(data, act_type="leaky", slope=0.25):
    """Only the ``gelu`` mode is ported: exact erf GELU, as the JAX op's
    ``jax.nn.gelu(approximate=False)``."""
    if act_type != "gelu":
        raise MXNetError(f"LeakyReLU act_type {act_type!r} is not ported "
                         "yet (only 'gelu'); see ROADMAP.md")
    return F.gelu(data, approximate="none")


@register("Dropout")
def _dropout(data, p=0.5, training=False, generator=None, axes=()):
    """Identity unless ``training``. When training, the keep mask is
    drawn from ``generator``, a ``torch.Generator`` on ``data``'s device,
    which the caller must pass."""
    if not training or p <= 0:
        return data
    if generator is None:
        raise MXNetError("Dropout in training mode needs a torch.Generator")
    shape = list(data.shape)
    for a in axes or ():
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.rand(shape, generator=generator, device=data.device) < keep
    return torch.where(mask, data / keep, torch.zeros((), dtype=data.dtype,
                                                      device=data.device))


@register("softmax")
def _softmax(data, axis=-1, temperature=None, length=None, use_length=False):
    """Softmax over ``axis``; ``use_length`` masks positions at or past
    ``length`` (per leading index) before normalising."""
    if temperature:
        data = data / temperature
    if use_length and length is not None:
        steps = torch.arange(data.shape[axis], device=data.device)
        mask = steps < length.unsqueeze(-1)
        data = data.masked_fill(~mask, float("-inf"))
    return torch.softmax(data, dim=axis)


@register("log_softmax")
def _log_softmax(data, axis=-1, temperature=None):
    if temperature:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


def _one_hot(label, num_classes, dtype):
    """``onehot(label)`` over a new last axis; an index outside
    ``[0, num_classes)`` (an ignored label such as -1) gives a row of
    zeros, as ``jax.nn.one_hot`` does. A float label is truncated to an
    integer first."""
    classes = torch.arange(num_classes, device=label.device)
    return (label.to(torch.int64).unsqueeze(-1) == classes).to(dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Forward softmax; backward MXNet's hand-written cross-entropy
    gradient (``softmax_output-inl.h``), the JAX op's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization, out_grad, smooth_alpha, axis):
        out = torch.softmax(data, dim=axis)
        ctx.save_for_backward(out, label)
        ctx.hyper = (grad_scale, ignore_label, use_ignore, normalization,
                     out_grad, smooth_alpha, axis)
        return out

    @staticmethod
    def backward(ctx, cot):
        out, label = ctx.saved_tensors
        (grad_scale, ignore_label, use_ignore, normalization, out_grad,
         smooth_alpha, axis) = ctx.hyper
        num_classes = out.shape[axis]
        onehot = _one_hot(label, num_classes, out.dtype).movedim(-1, axis)
        if smooth_alpha:
            onehot = onehot * (1.0 - smooth_alpha) + smooth_alpha / max(
                num_classes - 1, 1) * (1.0 - onehot)
        g = out - onehot
        valid = None
        if use_ignore:
            valid = (label != ignore_label).to(out.dtype)
            g = g * valid.unsqueeze(axis)
        if normalization == "batch":
            g = g / label.shape[0]
        elif normalization == "valid":
            count = valid.sum() if valid is not None else torch.tensor(
                float(label.numel()), dtype=out.dtype, device=out.device)
            g = g / torch.clamp(count, min=1.0)
        g = g * grad_scale
        if out_grad:
            g = g * cot
        return (g.to(out.dtype),) + (None,) * 8


@register("SoftmaxOutput", aliases=("Softmax",))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False, preserve_shape=False,
                    normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax over the last axis (axis 1 with ``multi_output``); its
    gradient is ``(softmax - onehot(label)) * grad_scale``, whatever the
    head gradient (unless ``out_grad``), masked where ``use_ignore`` and
    the label is ``ignore_label``, divided by the batch
    (``normalization="batch"``) or by the count of valid labels
    (``"valid"``); ``"null"`` sums over the batch. The label gets no
    gradient. ``preserve_shape`` is accepted and, as in the JAX op,
    changes nothing."""
    axis = 1 if multi_output else -1
    return _SoftmaxOutput.apply(data, label, grad_scale, ignore_label,
                                use_ignore, normalization, out_grad,
                                smooth_alpha, axis)
