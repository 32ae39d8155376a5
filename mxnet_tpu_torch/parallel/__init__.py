"""Parallelism layer: device meshes and the training step.

Counterpart of ``mxnet_tpu/parallel/__init__.py``. Ported so far:
``DeviceMesh`` (meshes of one device) and ``ShardedTrainer``. Ring
attention, pipelines, mixture-of-experts and NCCL data parallelism come
in later slices.
"""
from __future__ import annotations

from .mesh import DeviceMesh
from .sharded_trainer import ShardedTrainer

__all__ = ["DeviceMesh", "ShardedTrainer"]
