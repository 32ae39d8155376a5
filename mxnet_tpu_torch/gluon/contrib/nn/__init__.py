"""Contrib neural-network blocks."""
from __future__ import annotations

from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           MultiHeadAttention, PixelShuffle1D,
                           PixelShuffle2D, PixelShuffle3D, SparseEmbedding,
                           SyncBatchNorm, TransformerEncoderCell)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D", "MultiHeadAttention", "TransformerEncoderCell"]
