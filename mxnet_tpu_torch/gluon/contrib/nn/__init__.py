"""Contrib neural-network blocks."""
from __future__ import annotations

from .basic_layers import (MultiHeadAttention, SparseEmbedding,
                           TransformerEncoderCell)

__all__ = ["SparseEmbedding", "MultiHeadAttention", "TransformerEncoderCell"]
