"""Model zoo: counterpart of ``mxnet_tpu/gluon/model_zoo`` (only the
ResNet family so far; ``vision.get_model`` raises for the others)."""
from . import vision
from .vision import get_model

__all__ = ["vision", "get_model"]
