"""Attention op: the op-registration shim over the kernel layer.

Counterpart of ``mxnet_tpu/ops/pallas_ops.py`` (``_contrib_flash_attention``
:31-54), exposed as ``nd.contrib.flash_attention`` /
``F.contrib.flash_attention``. It routes through
:func:`mxnet_tpu_torch.kernels.flash.flash_attention`, which dispatches
each kernel family by device (the hand-written CUDA kernels on a card,
the plain PyTorch versions on the CPU) and carries gradients through the
backward kernels when a graph is recorded.
"""
from __future__ import annotations

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
