"""``mx.mod``: MXNet 1.x's Module API (``BaseModule``, ``Module``,
``BucketingModule``)."""
from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "BucketingModule", "Module"]
