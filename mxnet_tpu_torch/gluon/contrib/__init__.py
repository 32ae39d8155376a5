"""gluon.contrib: experimental blocks (``nn``)."""
from __future__ import annotations

from . import nn

__all__ = ["nn"]
