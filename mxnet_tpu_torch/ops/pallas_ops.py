"""Attention op: the op-registration shim over the kernel layer.

Counterpart of ``mxnet_tpu/ops/pallas_ops.py`` (``_contrib_flash_attention``
:31-54), exposed as ``nd.contrib.flash_attention`` /
``F.contrib.flash_attention``. It routes through
:func:`mxnet_tpu_torch.kernels.dispatch`: the hand-written CUDA kernel on
a card, the plain PyTorch version on the CPU.
"""
from __future__ import annotations

from .. import kernels as _kernels
from .registry import register


@register("_contrib_flash_attention")
def _contrib_flash_attention(q, k, v, scale=None, causal=False):
    """Fused attention over (B, H, S, D) tensors; ``scale=None`` means
    ``1/sqrt(D)``."""
    if q.ndim != 4:
        raise ValueError(f"flash_attention expects (B, H, S, D) inputs, got "
                         f"rank {q.ndim}")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _kernels.dispatch("flash_attention", q, k, v, float(scale),
                             causal=bool(causal))
