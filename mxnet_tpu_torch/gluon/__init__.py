"""Gluon: the imperative/hybrid high-level API."""
from . import contrib, nn
from .block import Block, HybridBlock
from .parameter import Parameter, ParameterDict

__all__ = ["nn", "contrib", "Block", "HybridBlock", "Parameter",
           "ParameterDict"]
