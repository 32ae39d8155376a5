"""Neural-net ops the serving and training paths use.

Counterpart of ``mxnet_tpu/ops/nn.py`` (FullyConnected :29, Convolution
:60, Pooling :118, _contrib_AdaptiveAvgPooling2D :180, BatchNorm :202,
LayerNorm :226, softmax :283, log_softmax :294, Activation :377,
LeakyReLU :391, Dropout :424, SoftmaxOutput :317-374, RNN :518). These
were plain XLA in the JAX package,
so here they are plain PyTorch (cuBLAS for the matrix products, cuDNN for
convolutions, BatchNorm and the fused RNN on the card). Layouts are the
JAX package's:
channels first (NCW, NCHW, NCDHW), convolution weights ``(num_filter,
C / num_group, *kernel)``. Dropout takes an explicit ``torch.Generator``
where the JAX op took a PRNG key. Deconvolution is not ported yet.
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
