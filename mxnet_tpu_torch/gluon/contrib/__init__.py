"""gluon.contrib: experimental blocks (``nn``) and the Estimator
(``estimator``)."""
from __future__ import annotations

from . import estimator, nn

__all__ = ["estimator", "nn"]
