"""Contrib blocks.

Counterpart of ``mxnet_tpu/gluon/contrib/nn/basic_layers.py``:
Concurrent (:16), HybridConcurrent (:29), Identity (:46), SparseEmbedding
(:52), SyncBatchNorm (:87), PixelShuffle1D/2D/3D (:116-150),
MultiHeadAttention (:154) and the pre-LN TransformerEncoderCell (:213).
Attention goes through ``F.contrib.flash_attention``, which on a card
launches the hand-written CUDA kernel (``kernels/flash.py``).
"""
from __future__ import annotations

import torch

from .... import ndarray as nd
from ...block import Block, HybridBlock
from ...nn import (BatchNorm, Dense, Dropout, HybridSequential, LayerNorm,
                   Sequential)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D", "MultiHeadAttention", "TransformerEncoderCell"]


class Concurrent(Sequential):
    """Runs every child on the same input and concatenates the outputs
    along ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return nd.concat(*[block(x) for block in self._children.values()],
                         dim=self.axis)


class HybridConcurrent(HybridSequential):
    """The hybridizable :class:`Concurrent`."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    forward = HybridBlock.forward

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    """Returns its input."""

    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """Embedding for large vocabularies. Its forward is the plain row
    gather and its gradient the dense buffer that backward fills;
    :meth:`grad_rows` gives the row-sparse view of it for the lazy SGD
    and the kvstore's row paths (JAX :71-81)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim}
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer)

    def forward(self, x):
        return nd.Embedding(x, self.weight.data(), **self._kwargs)

    def grad_rows(self, x):
        """The weight's gradient restricted to the rows ``x`` looks up, a
        row-sparse array (sorted unique rows) on the gradient's device."""
        from ....ndarray.sparse import row_sparse_array

        g = self.weight.grad()._data
        rows = torch.unique(x._data.detach().to(g.device).long())
        return row_sparse_array((g.index_select(0, rows), rows),
                                shape=tuple(g.shape))


class SyncBatchNorm(BatchNorm):
    """BatchNorm whose statistics MXNet reduces across ``num_devices``
    cards. On the one card of a process it is :class:`BatchNorm` (the JAX
    layer is BatchNorm under GSPMD's global reductions); the op
    ``SyncBatchNorm`` with ``ndev > 1`` raises (fault C26)."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, **kwargs):
        super().__init__(momentum=momentum, epsilon=epsilon,
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices


class _PixelShuffle(HybridBlock):
    _ndim = 2

    def __init__(self, factor):
        super().__init__()
        if isinstance(factor, int):
            factor = (factor,) * self._ndim
        self._factor = tuple(factor)

    def __repr__(self):
        return f"{type(self).__name__}({self._factor})"


class PixelShuffle1D(_PixelShuffle):
    """``(N, C * f, W) -> (N, C, W * f)``."""

    _ndim = 1

    def hybrid_forward(self, F, x):
        (f,) = self._factor
        n, cf, w = x.shape
        x = F.reshape(x, shape=(n, cf // f, f, w))
        x = F.transpose(x, axes=(0, 1, 3, 2))
        return F.reshape(x, shape=(n, cf // f, w * f))


class PixelShuffle2D(_PixelShuffle):
    """``(N, C * f1 * f2, H, W) -> (N, C, H * f1, W * f2)``."""

    _ndim = 2

    def hybrid_forward(self, F, x):
        f1, f2 = self._factor
        n, c, h, w = x.shape
        co = c // (f1 * f2)
        x = F.reshape(x, shape=(n, co, f1, f2, h, w))
        x = F.transpose(x, axes=(0, 1, 4, 2, 5, 3))
        return F.reshape(x, shape=(n, co, h * f1, w * f2))


class PixelShuffle3D(_PixelShuffle):
    """``(N, C * f1 * f2 * f3, D, H, W) -> (N, C, D * f1, H * f2,
    W * f3)``."""

    _ndim = 3

    def hybrid_forward(self, F, x):
        f1, f2, f3 = self._factor
        n, c, d, h, w = x.shape
        co = c // (f1 * f2 * f3)
        x = F.reshape(x, shape=(n, co, f1, f2, f3, d, h, w))
        x = F.transpose(x, axes=(0, 1, 5, 2, 6, 3, 7, 4))
        return F.reshape(x, shape=(n, co, d * f1, h * f2, w * f3))


class MultiHeadAttention(HybridBlock):
    """Multi-head self or cross attention over the flash kernel.
    Inputs and outputs are (batch, seq, units)."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by "
                             f"num_heads {num_heads}")
        self._units = units
        self._heads = num_heads
        self._causal = causal
        with self.name_scope():
            self.query = Dense(units, flatten=False, use_bias=True)
            self.key = Dense(units, flatten=False, use_bias=True)
            self.value = Dense(units, flatten=False, use_bias=True)
            self.proj = Dense(units, flatten=False, use_bias=True)
            self.drop = Dropout(dropout)

    def hybrid_forward(self, F, x, mem=None):
        """``mem=None``: self attention; else cross attention with keys
        and values from ``mem`` (B, S_kv, U)."""
        if mem is not None and self._causal:
            raise ValueError(
                "causal masking has no valid interpretation for cross "
                "attention (query and memory positions are different "
                "sequences); build the block with causal=False")
        kv = x if mem is None else mem

        def split(t):  # (B, S, U) -> (B, H, S, D)
            t = F.reshape(t, shape=(0, 0, self._heads, -1))
            return F.transpose(t, axes=(0, 2, 1, 3))

        q = split(self.query(x))
        k = split(self.key(kv))
        v = split(self.value(kv))
        out = F.contrib.flash_attention(q, k, v, causal=self._causal)
        out = F.reshape(F.transpose(out, axes=(0, 2, 1, 3)),
                        shape=(0, 0, -1))
        return self.drop(self.proj(out))


class TransformerEncoderCell(HybridBlock):
    """Pre-LN transformer encoder layer: LN -> MHA -> residual, LN ->
    FFN(GELU) -> residual. (B, S, U) in and out."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 causal=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.ln1 = LayerNorm()
            self.attn = MultiHeadAttention(units, num_heads,
                                           dropout=dropout, causal=causal)
            self.ln2 = LayerNorm()
            self.ffn1 = Dense(hidden_size, flatten=False)
            self.ffn2 = Dense(units, flatten=False)
            self.drop = Dropout(dropout)

    def hybrid_forward(self, F, x):
        x = x + self.attn(self.ln1(x))
        h = F.LeakyReLU(self.ffn1(self.ln2(x)), act_type="gelu")
        return x + self.drop(self.ffn2(h))
