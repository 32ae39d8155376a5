"""Gluon neural-net layers."""
from ..block import Block, HybridBlock, SymbolBlock
from .basic_layers import *  # noqa: F401,F403
from .basic_layers import __all__ as _basic_all
from .conv_layers import *  # noqa: F401,F403
from .conv_layers import __all__ as _conv_all

__all__ = ["Block", "HybridBlock", "SymbolBlock"] + list(_basic_all) \
    + list(_conv_all)
