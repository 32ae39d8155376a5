"""Gluon: the imperative/hybrid high-level API."""
from . import contrib, data, loss, model_zoo, nn, rnn, utils
from .block import Block, HybridBlock, SymbolBlock
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["nn", "rnn", "utils", "contrib", "data", "loss", "model_zoo",
           "Block", "HybridBlock", "SymbolBlock", "Parameter",
           "ParameterDict", "Trainer"]
