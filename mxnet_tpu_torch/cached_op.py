"""Write-back of stateful buffers.

Counterpart of ``update_state`` in ``mxnet_tpu/cached_op.py:77-86``, the
one piece of that module the port needs: BatchNorm's running statistics
are ``grad_req="null"`` parameters that a training forward rewrites. The
JAX package rebinds the handle in imperative mode and records the write
while tracing; the port always runs eagerly, so it rebinds, outside the
autograd graph. ``ShardedTrainer`` keeps the values from before the step
and selects them back when its non-finite guard skips the step.
"""
from __future__ import annotations

__all__ = ["update_state"]


def update_state(handle, new_value):
    """Rebind ``handle`` (a parameter's NDArray) to ``new_value``
    (an NDArray or a tensor), detached from any autograd graph."""
    new_raw = new_value._data if hasattr(new_value, "_data") else new_value
    handle._rebind(new_raw.detach())
