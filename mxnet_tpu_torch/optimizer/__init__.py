"""Optimizers (counterpart of ``mxnet_tpu/optimizer/``)."""
from .optimizer import *  # noqa: F401,F403
from .optimizer import __all__  # noqa: F401
