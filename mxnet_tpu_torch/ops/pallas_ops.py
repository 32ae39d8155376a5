"""Attention ops: the op-registration shims over the kernel layer.

Counterpart of ``mxnet_tpu/ops/pallas_ops.py`` (``_contrib_flash_attention``
:31-54 and ``_contrib_decode_attention`` :57-75), exposed as
``nd.contrib.flash_attention`` / ``F.contrib.flash_attention`` and
``nd.contrib.decode_attention`` / ``sym.contrib.decode_attention``.
Flash attention routes through
:func:`mxnet_tpu_torch.kernels.flash.flash_attention`, which dispatches
each kernel family by device (the hand-written CUDA kernels on a card,
the plain PyTorch versions on the CPU) and carries gradients through the
backward kernels when a graph is recorded.
"""
from __future__ import annotations

from .. import kernels as _kernels
from ..kernels import flash as _flash
from .registry import register


@register("_contrib_flash_attention")
def _contrib_flash_attention(q, k, v, scale=None, causal=False,
                             block_q=None, block_k=None, interpret=False):
    """Fused attention over (B, H, S, D) tensors; ``scale=None`` means
    ``1/sqrt(D)``. ``block_q``, ``block_k`` and ``interpret`` are the
    Pallas kernel's tiling and interpreter switches, which the JAX
    package's graphs carry as attributes; they are accepted so those
    graphs load, and do not change the result (the CUDA kernel picks its
    own tiles)."""
    if q.ndim != 4:
        raise ValueError(f"flash_attention expects (B, H, S, D) inputs, got "
                         f"rank {q.ndim}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _flash.flash_attention(q, k, v, scale, causal)


@register("_contrib_decode_attention")
def _contrib_decode_attention(q, k, v, lengths, scale=None, block_k=128,
                              interpret=False):
    """Single-query decode attention: ``q (B, H, D)`` against a padded KV
    cache ``k``/``v`` ``(B, H, S, D)`` with per-sequence valid ``lengths
    (B,)`` (each >= 1); ``scale=None`` means ``1/sqrt(D)``. Family
    ``decode_attention``: the CUDA kernel on a card reads only the filled
    cache rows, the plain masked softmax on the CPU. ``block_k`` and
    ``interpret`` are the Pallas kernel's switches; they are accepted so
    the JAX package's graphs load, and do not change the result."""
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(
            f"decode_attention expects q (B, H, D) and k/v (B, H, S, D), "
            f"got ranks {q.ndim}/{k.ndim}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _kernels.dispatch("decode_attention", q, k, v, lengths,
                             float(scale))
