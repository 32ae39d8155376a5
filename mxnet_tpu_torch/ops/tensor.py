"""Tensor ops the serving and training paths use.

Counterpart of ``mxnet_tpu/ops/tensor.py`` (pick :162, Embedding :182,
reshape :211, transpose :240, Flatten :255, slice_axis :292), of the
broadcast arithmetic the losses use and of ``elemwise_add``
(``mxnet_tpu/ops/math.py:146``), with the same MXNet semantics.
"""
from __future__ import annotations

import torch

from .registry import register


@register("Embedding")
def _embedding(data, weight, input_dim=None, output_dim=None,
               dtype="float32", sparse_grad=False):
    """Row gather. Ids may arrive as floats (MXNet's default array type):
    they are cast to integers first, truncating as the JAX op does
    (exact for ids below 2**24)."""
    return torch.nn.functional.embedding(data.to(torch.int64), weight)


@register("reshape", aliases=("Reshape",))
def _reshape(x, shape=()):
    """MXNet special codes: 0 copies the input dim at that position, -1
    is inferred, -2 copies all remaining dims."""
    tgt = []
    for i, s in enumerate(shape):
        if s == 0:
            tgt.append(x.shape[i])
        elif s == -2:
            tgt.extend(x.shape[i:])
        else:
            tgt.append(int(s))
    return x.reshape(tuple(tgt))


@register("transpose")
def _transpose(x, axes=()):
    """A view with permuted strides (it is not made contiguous here)."""
    axes = tuple(axes) if axes else tuple(reversed(range(x.ndim)))
    return x.permute(axes)


@register("Flatten", aliases=("flatten",))
def _flatten(x):
    return x.reshape(x.shape[0], -1)


@register("slice_axis")
def _slice_axis(x, axis=0, begin=0, end=None):
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(begin, end)
    return x[tuple(sl)]


@register("pick")
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data`` at ``index`` along ``axis``; indices (floats allowed) are
    truncated to integers and clipped into range."""
    idx = index.to(torch.int64).clamp(0, data.shape[axis] - 1)
    out = torch.take_along_dim(data, idx.unsqueeze(axis), dim=axis)
    return out if keepdims else out.squeeze(axis)


@register("broadcast_mul")
def _broadcast_mul(lhs, rhs):
    return lhs * rhs


@register("elemwise_add")
def _elemwise_add(lhs, rhs):
    """Sum of two arrays of one shape (``Symbol.__add__``, the residual
    connections of a traced encoder); use broadcast ops otherwise."""
    if lhs.shape != rhs.shape:
        raise ValueError(f"elemwise op requires identical shapes, got "
                         f"{tuple(lhs.shape)} vs {tuple(rhs.shape)}; use the "
                         "broadcast_* variant")
    return lhs + rhs


@register("square")
def _square(x):
    return torch.square(x)
