"""``mx.mod``: MXNet 1.x's Module API (``BaseModule``, ``Module``).
``BucketingModule`` is not ported yet (ROADMAP.md A6)."""
from .base_module import BaseModule, BatchEndParam
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "Module"]
