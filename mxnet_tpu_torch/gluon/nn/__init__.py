"""Gluon neural-net layers."""
from ..block import Block, HybridBlock
from .basic_layers import (Dense, Dropout, Embedding, HybridSequential,
                           LayerNorm, Sequential)

__all__ = ["Block", "HybridBlock", "Sequential", "HybridSequential",
           "Dense", "Dropout", "Embedding", "LayerNorm"]
