"""``mx.contrib``: post-training int8 quantization."""
from . import quantization

__all__ = ["quantization"]
