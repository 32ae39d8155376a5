"""``mx.contrib``: post-training int8 quantization and text utilities."""
from . import quantization, text

__all__ = ["quantization", "text"]
