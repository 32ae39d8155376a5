"""Contrib blocks the serving path uses.

Counterpart of ``mxnet_tpu/gluon/contrib/nn/basic_layers.py``:
SparseEmbedding (:52), MultiHeadAttention (:154) and the pre-LN
TransformerEncoderCell (:213). Attention goes through
``F.contrib.flash_attention``, which on a card launches the hand-written
CUDA kernel (``kernels/flash.py``).
"""
from __future__ import annotations

from .... import ndarray as nd
from ...block import Block, HybridBlock
from ...nn import Dense, Dropout, LayerNorm

__all__ = ["SparseEmbedding", "MultiHeadAttention", "TransformerEncoderCell"]


class SparseEmbedding(Block):
    """Embedding for large vocabularies. Its forward is the plain row
    gather; the row-sparse gradient comes with the training slice."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim}
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer)

    def forward(self, x):
        return nd.Embedding(x, self.weight.data(), **self._kwargs)


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
