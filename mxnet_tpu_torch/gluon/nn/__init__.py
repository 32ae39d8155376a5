"""Gluon neural-net layers."""
from ..block import Block, HybridBlock
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, HybridSequential, LayerNorm, Sequential)
from .conv_layers import *  # noqa: F401,F403
from .conv_layers import __all__ as _conv_all

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential",
           "Dense", "Dropout", "BatchNorm", "Embedding", "LayerNorm",
           "Flatten", "Activation"] + list(_conv_all)
