"""Parallelism layer: device meshes and the training step.

Counterpart of ``mxnet_tpu/parallel/__init__.py``. Ported so far:
``DeviceMesh`` (meshes of one device), ``ShardedTrainer`` and
``sharding_rules``. Ring
attention, pipelines, mixture-of-experts and NCCL data parallelism come
in later slices.
"""
from __future__ import annotations

from .mesh import DeviceMesh
from .sharded_trainer import ShardedTrainer, sharding_rules

__all__ = ["DeviceMesh", "ShardedTrainer", "sharding_rules"]
