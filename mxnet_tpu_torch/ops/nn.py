"""Neural-net ops the serving and training paths use.

Counterpart of ``mxnet_tpu/ops/nn.py``, all 29 names (FullyConnected
:29, Convolution :60, Deconvolution :86, Pooling :118,
_contrib_AdaptiveAvgPooling2D :180, BatchNorm :202, LayerNorm :226,
GroupNorm :236, InstanceNorm :249, L2Normalization :259, LRN :272,
softmax :283, log_softmax :294, softmin :301, SoftmaxActivation :306,
SoftmaxOutput :317-374, Activation :377, LeakyReLU :391 in every mode,
Dropout :424, MakeLoss :443, smooth_l1 :448, CTCLoss :456, RNN :518,
UpSampling :626, Crop :657, make_loss :674, relu6 :681,
_contrib_BatchNormWithReLU :686, _contrib_SparseEmbedding :702). These
were plain XLA in the JAX package, so here they are plain PyTorch
(cuBLAS for the matrix products, cuDNN for convolutions, transposed
convolutions, BatchNorm and the fused RNN on the card). Layouts are the
JAX package's: channels first (NCW, NCHW, NCDHW), convolution weights
``(num_filter, C / num_group, *kernel)``, deconvolution weights ``(C,
num_filter / num_group, *kernel)`` (MXNet's, which is also
``conv_transpose``'s). Dropout and LeakyReLU's ``rrelu`` take an explicit
``torch.Generator`` where the JAX ops took a PRNG key.

Where the JAX ops depart from MXNet 1.x the port follows MXNet, each with
a test that asserts both behaviours (``ROADMAP.md`` C): grouped
Deconvolution (C15: the JAX op raises), Deconvolution's ``target_shape``
(C18: the JAX op ignores it), CTCLoss's padding value with
``blank_label="first"`` (C16: MXNet pads with 0, the JAX op counts 0 as
a label) and MakeLoss / make_loss's backward (C17: MXNet writes
``grad_scale`` normalised by ``normalization``, or ones for make_loss,
whatever the head gradient; the JAX ops are the identity).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import random as _random
from ..base import MXNetError
from ..kernels import DeviceError, count
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


_SELU_ALPHA, _SELU_LAMBDA = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU")
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, training=False,
                generator=None):
    """The JAX op's modes: ``leaky`` (``slope * x`` below zero),
    ``prelu`` (the learned ``gamma``, one slope per channel of axis 1 or
    one for all), ``elu`` (``slope * expm1(x)``), ``selu``, ``gelu``
    (exact erf, ``jax.nn.gelu(approximate=False)``) and ``rrelu``: in
    training, with ``generator`` (a ``torch.Generator`` on ``data``'s
    device), a slope drawn from ``U(lower_bound, upper_bound)`` per
    element, otherwise their midpoint."""
    neg = data > 0
    if act_type == "rrelu" and training and generator is not None:
        slopes = torch.rand(data.shape, generator=generator,
                            device=data.device, dtype=data.dtype)
        slopes = slopes * (upper_bound - lower_bound) + lower_bound
        return torch.where(neg, data, slopes * data)
    if act_type == "leaky":
        return torch.where(neg, data, slope * data)
    if act_type == "prelu":
        g = gamma
        if g.ndim < data.ndim and data.ndim > 1:
            g = g.reshape((1, -1) + (1,) * (data.ndim - 2))
        return torch.where(neg, data, g * data)
    if act_type == "elu":
        return torch.where(neg, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_LAMBDA * torch.where(neg, data,
                                          _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(neg, data, mid * data)
    raise ValueError(f"unknown LeakyReLU act_type {act_type}")


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


# ------------------------------------------------------------------- RNN ---

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}


class _RNNRoutes:
    """Layer runs of the RNN op on the card, by route: ``"cudnn"`` (one
    ``torch._VF`` call, over one layer or all of them) and ``"steps"``
    (one layer and direction of the per-step form). Counted through
    ``kernels.count``, so a captured run counts at each replay."""

    def __init__(self):
        self.calls = {"cudnn": 0, "steps": 0}

    def reset(self):
        self.calls = dict.fromkeys(self.calls, 0)


rnn_routes = _RNNRoutes()


def rnn_param_size(input_size, state_size, num_layers=1, mode="lstm",
                   bidirectional=False):
    """Length of the flat parameter vector (MXNet's ``GetRnnParamSize``;
    the JAX package's ``symbol._rnn_param_size``)."""
    ng, ndir, total = _GATES[mode], 2 if bidirectional else 1, 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * ndir
        # W_x, W_h, b_x and b_h of each direction
        total += ndir * ng * state_size * (isz + state_size + 2)
    return total


def rnn_weights(params, mode, num_layers, ndir, input_size, state_size):
    """``[(w_x, w_h, b_x, b_h)]`` per layer and direction (layer-major),
    views into the flat vector ``params``, which holds every layer's and
    direction's ``[W_x, W_h]`` first, then every ``[b_x, b_h]`` (the
    JAX op's order, ``mxnet_tpu/ops/nn.py:547-560``); no copy."""
    ng, h = _GATES[mode], state_size
    want = rnn_param_size(input_size, h, num_layers, mode, ndir == 2)
    if params.ndim != 1 or params.numel() != want:
        raise MXNetError(f"RNN: the parameter vector has shape "
                         f"{tuple(params.shape)}; {mode} with {num_layers} "
                         f"layer(s), {ndir} direction(s), input {input_size} "
                         f"and state {h} needs ({want},)")
    offset = 0

    def take(*shape):
        nonlocal offset
        n = math.prod(shape)
        view = params[offset:offset + n].view(shape)
        offset += n
        return view

    ws = [(take(ng * h, input_size if layer == 0 else h * ndir),
           take(ng * h, h))
          for layer in range(num_layers) for _ in range(ndir)]
    bs = [(take(ng * h), take(ng * h)) for _ in range(num_layers * ndir)]
    return [w + b for w, b in zip(ws, bs)]


def _rnn_one_way(x, weights, h, c, mode, clip):
    """One layer and direction of the per-step form over ``x`` (T, B,
    I): the input projection of every step in one product, then per
    step ``h @ W_h^T + b_h`` and the gates (LSTM ``i, f, g, o``; GRU
    ``r, z, n`` with ``n = tanh(W_n x + b_n + r * (W_hn h + b_hn))``).
    Returns ``(outputs (T, B, H), h, c)``."""
    wx, wh, bx, bh = weights
    steps, batch = x.shape[0], x.shape[1]
    gx = torch.addmm(bx, x.reshape(steps * batch, -1), wx.t()).view(
        steps, batch, -1)
    outs = []
    for t in range(steps):
        gh = torch.addmm(bh, h, wh.t())
        if mode == "lstm":
            i, f, g, o = (gx[t] + gh).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            if clip is not None:
                c = c.clamp(*clip)
            h = torch.sigmoid(o) * torch.tanh(c)
        elif mode == "gru":
            rx, zx, nx = gx[t].chunk(3, dim=-1)
            rh, zh, nh = gh.chunk(3, dim=-1)
            r = torch.sigmoid(rx + rh)
            z = torch.sigmoid(zx + zh)
            n = torch.tanh(nx + r * nh)
            h = (1 - z) * n + z * h
        else:
            pre = gx[t] + gh
            h = torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)
        outs.append(h)
    return torch.stack(outs), h, c


def _rnn_steps(x, weights, h0, c0, mode, ndir, clip):
    """Layers ``weights`` (a list per direction) of the per-step form;
    ``h0``/``c0`` hold one state per direction. Returns ``(out, [h],
    [c])``."""
    outs, hs, cs = [], [], []
    for d in range(ndir):
        seq = x.flip(0) if d == 1 else x
        c = c0[d] if c0 is not None else None
        y, h, c = _rnn_one_way(seq, weights[d], h0[d], c, mode, clip)
        outs.append(y.flip(0) if d == 1 else y)
        hs.append(h)
        cs.append(c)
    return (torch.cat(outs, dim=-1) if ndir == 2 else outs[0]), hs, cs


def _rnn_cudnn(x, weights, h0, c0, mode, ndir):
    """Layers ``weights`` (layer-major, one tuple per layer and
    direction) in one cuDNN RNN call through ``torch._VF``, which takes
    the per-layer views as its weight list (and compacts them into its
    own buffer at each call: the flat vector is in MXNet's order, not
    cuDNN's). Returns ``(out, hn, cn)`` over those layers."""
    flat = [w for layer in weights for w in layer]
    num_layers = len(weights) // ndir
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x, h0] + flat +
        ([c0] if c0 is not None else []))
    fn = getattr(torch._VF, mode)   # lstm, gru, rnn_tanh, rnn_relu
    count(rnn_routes, "calls", "cudnn")
    if mode == "lstm":
        out, hn, cn = fn(x, (h0, c0), flat, True, num_layers, 0.0, train,
                         ndir == 2, False)
        return out, hn, cn
    out, hn = fn(x, h0, flat, True, num_layers, 0.0, train, ndir == 2,
                 False)
    return out, hn, None


def _rnn_route(tensors, clip):
    """``"plain"`` for CPU (or ``meta``) tensors, on the card
    ``"cudnn"``, or ``"steps"`` where cuDNN cannot do the op (LSTM state
    clipping): ``kernels.dispatch``'s rule."""
    devices = {t.device.type for t in tensors}
    if devices in ({"cpu"}, {"meta"}):
        return "plain"
    if devices == {"cuda"}:
        return "steps" if clip is not None else "cudnn"
    raise DeviceError(f"RNN: tensors on devices {sorted(devices)}; expected "
                      "all on the CPU or all on one CUDA card")


def rnn_run(route, data, params, state, state_cell, state_size, num_layers,
            mode, bidirectional, clip=None, p=0.0, generator=None):
    """The RNN op's layers on ``route``: ``"cudnn"`` (``torch._VF``, on
    any device torch runs it on), ``"steps"`` (the per-step form,
    counted as a card route) or ``"plain"`` (the per-step form). ``p >
    0`` drops between layers with masks from ``generator``; ``clip`` is
    LSTM's ``(min, max)`` cell clip, which only the per-step form does.
    Returns ``(out, hn, cn)``, ``cn`` None outside LSTM."""
    ndir = 2 if bidirectional else 1
    lstm = mode == "lstm"
    weights = rnn_weights(params, mode, num_layers, ndir, data.shape[2],
                          state_size)
    drop = p > 0 and num_layers > 1
    x, hs, cs = data, [], []
    # cuDNN takes every layer in one call unless dropout comes between
    groups = [range(num_layers)] if route == "cudnn" and not drop else \
        [range(layer, layer + 1) for layer in range(num_layers)]
    for g in groups:
        rows = slice(g[0] * ndir, (g[-1] + 1) * ndir)
        c0 = state_cell[rows] if lstm else None
        if route == "cudnn":
            x, h, c = _rnn_cudnn(x, weights[rows], state[rows], c0, mode,
                                 ndir)
            hs.append(h)
            cs.append(c)
        else:
            if route == "steps":
                count(rnn_routes, "calls", "steps", ndir)
            x, h, c = _rnn_steps(x, weights[rows], state[rows], c0, mode,
                                 ndir, clip)
            hs.append(torch.stack(h))
            cs.append(torch.stack(c) if lstm else None)
        if drop and g[-1] < num_layers - 1:
            x = _dropout(x, p, True, generator)
    hn = torch.cat(hs) if len(hs) > 1 else hs[0]
    cn = (torch.cat(cs) if len(cs) > 1 else cs[0]) if lstm else None
    return x, hn, cn


@register("RNN", num_outputs=3)
def _rnn(data, params, state, state_cell=None, state_size=0, num_layers=1,
         mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
         projection_size=None, lstm_state_clip_min=None,
         lstm_state_clip_max=None, lstm_state_clip_nan=False,
         use_sequence_length=False, sequence_length=None, training=False,
         generator=None):
    """The fused multi-layer RNN (MXNet's ``src/operator/rnn.cc``; the
    JAX op ``mxnet_tpu/ops/nn.py:518-623``) over ``data`` (T, B, I),
    modes ``lstm``, ``gru``, ``rnn_tanh`` and ``rnn_relu``, the flat
    ``params`` vector (every layer's and direction's weights, then every
    bias), ``state`` (and ``state_cell`` for LSTM) of shape
    (layers * directions, B, H). Returns ``(out, hn, cn)`` always, ``cn``
    zeros outside LSTM, as the JAX op does.

    On the card the layers run through cuDNN (``torch._VF``) on views of
    ``params``; LSTM state clipping, which cuDNN does not do, runs the
    per-step form there. On the CPU the per-step form is the plain
    version. ``p`` is applied as MXNet 1.x does and the JAX op does not
    (ROADMAP.md C12): in training, dropout on each layer's output but
    the last, the layers then run one call each with the mask drawn
    between them from ``generator`` (``mx.random``'s generator of the
    data's device by default, which every CUDA graph registers).
    ``projection_size`` and ``use_sequence_length`` raise;
    ``lstm_state_clip_nan`` is ignored, as in the JAX op."""
    if projection_size:
        raise MXNetError("RNN: projection_size (LSTMP) is not ported; the "
                         "JAX op ignores it")
    if use_sequence_length:
        raise MXNetError("RNN: use_sequence_length is not ported; the JAX "
                         "op ignores it")
    if mode not in _GATES:
        raise MXNetError(f"RNN: mode must be one of {sorted(_GATES)}, got "
                         f"{mode!r}")
    lstm = mode == "lstm"
    if lstm and state_cell is None:
        raise MXNetError("RNN: mode lstm needs state_cell")
    clip = None
    if lstm and lstm_state_clip_min is not None:
        clip = (lstm_state_clip_min, lstm_state_clip_max)
    route = _rnn_route([data, params, state] +
                       ([state_cell] if lstm else []), clip)
    drop = p if training else 0.0
    if drop > 0 and num_layers > 1 and generator is None:
        generator = _random.generator(data.device)
    out, hn, cn = rnn_run(route, data, params, state, state_cell, state_size,
                          num_layers, mode, bidirectional, clip, drop,
                          generator)
    return out, hn, cn if lstm else torch.zeros_like(hn)


# ------------------------------------------------------- Deconvolution ---

_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def deconv_pads(in_spatial, kernel, stride, dilate, pad, adj, target_shape):
    """``(pad, adj)`` per spatial dim. With a ``target_shape`` (any
    non-zero entry) they follow from it as MXNet 1.x derives them
    (``deconvolution-inl.h``, ``InferPad``): the full output ``stride *
    (in - 1) + dilate * (k - 1) + 1`` less the target, split into ``pad =
    (excess + 1) // 2`` and ``adj = excess % 2``; otherwise they are the
    given ones."""
    if not target_shape or not any(target_shape):
        return pad, adj
    pads, adjs = [], []
    for i, target in enumerate(target_shape):
        full = stride[i] * (in_spatial[i] - 1) + dilate[i] * (
            kernel[i] - 1) + 1
        if full < target:
            raise MXNetError(f"Deconvolution: target_shape {target} is "
                             f"larger than the full output {full}")
        excess = full - target
        pads.append((excess + 1) // 2)
        adjs.append(excess % 2)
    return tuple(pads), tuple(adjs)


@register("Deconvolution")
def _deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), target_shape=(), num_filter=1,
                   num_group=1, no_bias=True, layout=None, cudnn_off=False,
                   workspace=1024, cudnn_tune=None):
    """The transposed convolution (``conv_transpose{1,2,3}d``, cuDNN on
    the card) with weight ``(C, num_filter / num_group, *kernel)``, ``adj``
    as ``output_padding`` and ``num_group`` groups (fault C15: the JAX op
    raises for ``num_group > 1``); ``target_shape`` sets ``pad`` and
    ``adj`` as MXNet does (fault C18: the JAX op ignores it)."""
    n = len(kernel) if kernel else weight.ndim - 2
    kernel = tuple(kernel) if kernel else tuple(weight.shape[2:])
    stride = _tuplize(stride or 1, n)
    dilate = _tuplize(dilate or 1, n)
    pad, adj = deconv_pads(tuple(data.shape[2:]), kernel, stride, dilate,
                           _tuplize(pad or 0, n), _tuplize(adj or 0, n),
                           tuple(target_shape or ()))
    return _CONV_T[n](data, weight, None if no_bias else bias, stride, pad,
                      adj, num_group, dilate)


# ------------------------------------------------------------- norms -----

def _channel_shape(data):
    return (1, data.shape[1]) + (1,) * (data.ndim - 2)


@register("GroupNorm")
def _group_norm(data, gamma, beta, num_groups=1, eps=1e-5,
                output_mean_var=False):
    """Normalise over each group of ``C / num_groups`` channels and the
    spatial dims (biased variance), then scale and shift per channel."""
    b, c = data.shape[:2]
    x = data.reshape((b, num_groups, c // num_groups) + data.shape[2:])
    red = tuple(range(2, x.ndim))
    mean = torch.mean(x, dim=red, keepdim=True)
    var = torch.var(x, dim=red, keepdim=True, unbiased=False)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    return x * gamma.reshape(_channel_shape(data)) + \
        beta.reshape(_channel_shape(data))


@register("InstanceNorm")
def _instance_norm(data, gamma, beta, eps=1e-3):
    """Normalise each channel of each sample over its spatial dims."""
    red = tuple(range(2, data.ndim))
    mean = torch.mean(data, dim=red, keepdim=True)
    var = torch.var(data, dim=red, keepdim=True, unbiased=False)
    out = (data - mean) * torch.rsqrt(var + eps)
    return out * gamma.reshape(_channel_shape(data)) + \
        beta.reshape(_channel_shape(data))


@register("L2Normalization")
def _l2_normalization(data, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data^2) + eps)`` over every non-batch dim
    (``instance``), the channels (``channel``) or the spatial dims
    (``spatial``)."""
    if mode == "instance":
        red = tuple(range(1, data.ndim))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, data.ndim))
    norm = torch.sqrt(torch.sum(torch.square(data), dim=red, keepdim=True)
                      + eps)
    return data / norm


@register("LRN")
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalisation across ``nsize`` channels (NCHW)."""
    sq = torch.square(data)
    half = nsize // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    windows = padded[:, 0:data.shape[1]]
    for i in range(1, nsize):
        windows = windows + padded[:, i:i + data.shape[1]]
    return data / torch.pow(knorm + alpha / nsize * windows, beta)


@register("softmin")
def _softmin(data, axis=-1):
    return torch.softmax(-data, dim=axis)


@register("SoftmaxActivation")
def _softmax_activation(data, mode="instance"):
    """Softmax over the channels (``channel``) or over each sample's
    flattened values (``instance``)."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


# -------------------------------------------------------------- losses ---

class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward writes ``grad_scale`` (divided by
    the batch or by the count of values above ``valid_thresh``) whatever
    the head gradient, as MXNet 1.x's ``make_loss-inl.h``."""

    @staticmethod
    def forward(ctx, data, grad_scale, valid_thresh, normalization):
        ctx.hyper = (grad_scale, valid_thresh, normalization)
        ctx.save_for_backward(data)
        return data.clone()

    @staticmethod
    def backward(ctx, cot):
        (data,) = ctx.saved_tensors
        grad_scale, valid_thresh, normalization = ctx.hyper
        g = torch.full_like(data, grad_scale)
        if normalization == "batch":
            g = g / data.shape[0]
        elif normalization == "valid":
            valid = (data > valid_thresh).sum().to(data.dtype)
            g = g / torch.clamp(valid, min=1.0)
        return g, None, None, None


@register("MakeLoss")
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """A loss head: the forward is ``data``; the gradient is
    ``grad_scale`` (``normalization``: ``"null"``, ``"batch"`` or
    ``"valid"``), not the head gradient (fault C17: the JAX op is the
    identity)."""
    return _MakeLoss.apply(data, grad_scale, valid_thresh, normalization)


@register("make_loss")
def _make_loss_op(data):
    """MXNet's ``make_loss``: the forward is ``data``, the gradient ones
    (fault C17)."""
    return _MakeLoss.apply(data, 1.0, 0.0, "null")


@register("smooth_l1")
def _smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2,
                       0.5 * s2 * torch.square(data),
                       torch.abs(data) - 0.5 / s2)


def ctc_lengths(label, blank_label, label_lengths=None):
    """The label lengths as MXNet 1.x reads a padded label: up to the
    first padding value, 0 when the blank is ``"first"`` and -1 when it
    is ``"last"`` (fault C16: the JAX op counts every label >= 0, so a
    0-padded label keeps its padding as labels)."""
    lab = label.to(torch.int64)
    if label_lengths is not None:
        return label_lengths.to(torch.int64)
    pad = 0 if blank_label == "first" else -1
    is_pad = (lab == pad).to(torch.int64)
    # index of the first padding value, or L
    first = torch.where(is_pad.cumsum(1) > 0, 0, 1).sum(1)
    return first


def ctc_plain(logp, lab, lab_len, dat_len, blank):
    """The negative log-likelihood by the log-space alpha recursion, op
    for op the JAX op's ``lax.scan`` (``mxnet_tpu/ops/nn.py:480-515``), as
    a loop over time: the CPU route and the card's check of torch's."""
    t_len, b, _ = logp.shape
    s = 2 * lab.shape[1] + 1
    pos = torch.arange(lab.shape[1], device=lab.device)
    ext = torch.full((b, s), blank, dtype=torch.int64, device=lab.device)
    ext[:, 1::2] = torch.where(pos < lab_len[:, None], lab, blank)
    neg_inf = torch.tensor(-1e30, dtype=logp.dtype, device=logp.device)
    a0 = torch.full((b, s), -1e30, dtype=logp.dtype, device=logp.device)
    a0[:, 0] = logp[0, :, blank]
    a0[:, 1] = torch.gather(logp[0], 1, ext[:, 1:2])[:, 0]

    def lse3(x, y, z):
        m = torch.maximum(torch.maximum(x, y), z)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        return m + torch.log(torch.exp(x - m) + torch.exp(y - m)
                             + torch.exp(z - m))

    same = (ext == torch.roll(ext, 2, dims=1)) | (ext == blank)
    alphas = [a0]
    alpha = a0
    for t in range(1, t_len):
        shift1 = torch.cat([neg_inf.expand(b, 1), alpha[:, :-1]], dim=1)
        shift2 = torch.cat([neg_inf.expand(b, 2), alpha[:, :-2]], dim=1)
        shift2 = torch.where(same, neg_inf, shift2)
        alpha = lse3(alpha, shift1, shift2) + torch.gather(logp[t], 1, ext)
        alphas.append(alpha)
    alphas = torch.stack(alphas)
    a_last = alphas[dat_len - 1, torch.arange(b, device=logp.device)]
    end1 = torch.gather(a_last, 1, (2 * lab_len)[:, None])[:, 0]
    end2 = torch.gather(a_last, 1, torch.clamp(2 * lab_len - 1,
                                               min=0)[:, None])[:, 0]
    m = torch.maximum(end1, end2)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return -(m + torch.log(torch.exp(end1 - m) + torch.exp(end2 - m)))


@register("CTCLoss", aliases=("ctc_loss",))
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first"):
    """CTC's negative log-likelihood per sequence. ``data`` is ``(T, B,
    V)`` unnormalised activations; the blank is channel 0 (``"first"``)
    or V - 1 (``"last"``); ``label`` is ``(B, L)``, padded with 0 or -1
    as ``ctc_lengths`` reads it. The route follows the device, decided
    before any launch: on the card ``torch.nn.functional.ctc_loss``
    (``reduction="none"``, no clamp of infinite losses, as the JAX op has
    none), on the CPU the plain recursion (``ctc_plain``)."""
    t_len, b, v = data.shape
    logp = torch.log_softmax(data, dim=-1)
    blank = 0 if blank_label == "first" else v - 1
    lab = label.to(torch.int64)
    lab_len = ctc_lengths(lab, blank_label, label_lengths
                          if use_label_lengths else None)
    dat_len = data_lengths.to(torch.int64) if (
        use_data_lengths and data_lengths is not None) else torch.full(
        (b,), t_len, dtype=torch.int64, device=data.device)
    if data.device.type == "cuda":
        pos = torch.arange(lab.shape[1], device=lab.device)
        targets = torch.where(pos < lab_len[:, None], lab,
                              torch.zeros_like(lab)).clamp_(min=0)
        return F.ctc_loss(logp, targets, dat_len, lab_len, blank=blank,
                          reduction="none", zero_infinity=False)
    return ctc_plain(logp, lab, lab_len, dat_len, blank)


# --------------------------------------------------- resizing and crop ---

@register("UpSampling")
def _upsampling(*args, scale=1, sample_type="nearest", num_filter=0,
                multi_input_mode="concat", num_args=1, workspace=512):
    """Nearest-neighbour upsampling by ``scale`` (several inputs: each to
    the first one's upsampled size, then concatenated on the channels or
    summed); ``bilinear`` interpolates the first input (half-pixel
    centres, as ``jax.image.resize``'s ``linear``) and ignores the
    deconvolution weight, as the JAX op does."""
    if sample_type != "nearest":
        return F.interpolate(args[0], scale_factor=scale, mode="bilinear",
                             align_corners=False)
    out_h, out_w = args[0].shape[2] * scale, args[0].shape[3] * scale
    ups = []
    for i, d in enumerate(args):
        if out_h % d.shape[2] or out_w % d.shape[3]:
            raise ValueError(
                f"UpSampling: input {i} spatial {tuple(d.shape[2:])} does "
                f"not divide the target size ({out_h}, {out_w})")
        fh, fw = out_h // d.shape[2], out_w // d.shape[3]
        ups.append(d.repeat_interleave(fh, dim=2).repeat_interleave(fw,
                                                                    dim=3))
    if len(ups) == 1:
        return ups[0]
    if multi_input_mode == "sum":
        return sum(ups[1:], ups[0])
    return torch.cat(ups, dim=1)


@register("Crop")
def _crop(data, like=None, offset=(0, 0), h_w=(0, 0), num_args=1,
          center_crop=False):
    """Crop to ``like``'s spatial size (or ``h_w``) at ``offset`` or in
    the centre."""
    th, tw = (like.shape[2], like.shape[3]) if like is not None else h_w
    h, w = data.shape[2], data.shape[3]
    oy, ox = ((h - th) // 2, (w - tw) // 2) if center_crop else offset
    return data[:, :, oy:oy + th, ox:ox + tw]


@register("relu6")
def _relu6(data):
    return torch.clamp(data, 0.0, 6.0)


@register("_contrib_BatchNormWithReLU", num_outputs=3)
def _batch_norm_with_relu(data, gamma, beta, moving_mean, moving_var,
                          eps=1e-3, momentum=0.9, fix_gamma=True,
                          use_global_stats=False, output_mean_var=False,
                          axis=1, cudnn_off=False, training=True):
    """BatchNorm followed by ReLU on its output."""
    out, mean, var = _batch_norm(
        data, gamma, beta, moving_mean, moving_var, eps=eps,
        momentum=momentum, fix_gamma=fix_gamma,
        use_global_stats=use_global_stats, axis=axis, training=training)
    return torch.relu(out), mean, var


def _register_sparse_embedding():
    """``_contrib_SparseEmbedding`` is the Embedding op (a dense
    gradient, as in the JAX package)."""
    from .registry import _REGISTRY

    register("_contrib_SparseEmbedding")(_REGISTRY["Embedding"])


_register_sparse_embedding()
