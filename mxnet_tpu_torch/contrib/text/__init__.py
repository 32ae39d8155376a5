"""``mx.contrib.text``: vocabularies, token counting and token
embeddings.

Counterpart of ``mxnet_tpu/contrib/text/`` (MXNet 1.x
``python/mxnet/contrib/text/``). An embedding's matrix is an NDArray
that drops into ``gluon.nn.Embedding(...).weight``.
"""
from __future__ import annotations

from . import embedding, utils, vocab
from .vocab import Vocabulary

__all__ = ["embedding", "utils", "vocab", "Vocabulary"]
