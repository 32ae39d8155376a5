"""The port's gluon blocks against the JAX package's: MultiHeadAttention
(self and cross) and TransformerEncoderCell, with the JAX block's
weights carried across by mxnet_tpu_torch.convert.load_jax_params; plus
naming, deferred shapes and the loader's checks."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.contrib import nn as jcnn
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.contrib import nn as cnn

# f32 on the CPU through a few dense layers, both frameworks, different
# summation orders
RTOL, ATOL = 1e-5, 1e-5
CPU = mx.cpu()


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax_params(block, seed=10):
    """The JAX block's parameters by structural name, with biases and
    LayerNorm parameters perturbed so they are not all 0 or 1."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, p in block._collect_params_with_structure().items():
        a = p.data().asnumpy()
        if a.ndim == 1:
            a = a + 0.1 * rs.randn(*a.shape).astype(np.float32)
        out[name] = a
    return out


def _pair(make_jax, make_port, *inputs):
    jblock = make_jax()
    jblock.initialize(jmx.init.Xavier())
    jblock(*(jmx.nd.array(x) for x in inputs))  # resolve deferred shapes
    params = _jax_params(jblock)
    for name, value in params.items():
        jblock._collect_params_with_structure()[name].set_data(
            jmx.nd.array(value))
    jout = jblock(*(jmx.nd.array(x) for x in inputs)).asnumpy()
    pblock = make_port()
    pblock.initialize(ctx=CPU)
    assert load_jax_params(pblock, params) == len(params)
    pout = pblock(*(mx.nd.array(x, ctx=CPU) for x in inputs)).asnumpy()
    return jout, pout


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_self(causal):
    x = _rand(2, 16, 32)
    jout, pout = _pair(lambda: jcnn.MultiHeadAttention(32, 4, causal=causal),
                       lambda: cnn.MultiHeadAttention(32, 4, causal=causal),
                       x)
    np.testing.assert_allclose(pout, jout, rtol=RTOL, atol=ATOL)


def test_multi_head_attention_cross():
    x, mem = _rand(2, 12, 32), _rand(2, 20, 32, seed=1)
    jout, pout = _pair(lambda: jcnn.MultiHeadAttention(32, 4),
                       lambda: cnn.MultiHeadAttention(32, 4), x, mem)
    assert pout.shape == (2, 12, 32)
    np.testing.assert_allclose(pout, jout, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="causal"):
        blk = cnn.MultiHeadAttention(32, 4, causal=True)
        blk.initialize(ctx=CPU)
        blk(mx.nd.array(x, ctx=CPU), mx.nd.array(mem, ctx=CPU))


def test_transformer_encoder_cell():
    x = _rand(3, 16, 32)
    jout, pout = _pair(lambda: jcnn.TransformerEncoderCell(32, 64, 4),
                       lambda: cnn.TransformerEncoderCell(32, 64, 4), x)
    np.testing.assert_allclose(pout, jout, rtol=RTOL, atol=ATOL)


def test_structural_names_prefixes_and_deferred_shapes():
    cell = cnn.TransformerEncoderCell(32, 64, 4, prefix="cell_")
    names = list(cell._collect_params_with_structure())
    assert names[:4] == ["ln1.gamma", "ln1.beta", "attn.query.weight",
                         "attn.query.bias"]
    assert names == list(jcnn.TransformerEncoderCell(
        32, 64, 4)._collect_params_with_structure())
    assert all(k.startswith("cell_") for k in cell.collect_params())
    assert len(cell.collect_params(".*layernorm.*")) == 4
    assert cell.attn.query.weight.shape == (32, 0)
    cell.initialize(ctx=CPU, generator=torch.Generator().manual_seed(0))
    cell.hybridize()  # a flag in this slice: the forward stays eager
    cell(mx.nd.array(_rand(1, 5, 32), ctx=CPU))
    assert cell.attn.query.weight.shape == (32, 32)
    assert cell.ffn2.weight.data().shape == (32, 64)


def test_load_jax_params_rejects_mismatches():
    def fresh():
        blk = mx.gluon.nn.Dense(4, in_units=3)
        blk.initialize(ctx=CPU)
        return blk

    good = {"weight": _rand(4, 3), "bias": _rand(4)}
    blk = fresh()
    load_jax_params(blk, good)
    np.testing.assert_array_equal(blk.weight.data().asnumpy(),
                                  good["weight"])
    with pytest.raises(mx.MXNetError, match="missing"):
        load_jax_params(fresh(), {"weight": good["weight"]})
    with pytest.raises(mx.MXNetError, match="unexpected"):
        load_jax_params(fresh(), dict(good, extra=_rand(1)))
    with pytest.raises(mx.MXNetError, match="shape"):
        load_jax_params(fresh(), dict(good, weight=_rand(3, 4)))
    with pytest.raises(mx.MXNetError, match="float64"):
        load_jax_params(fresh(), dict(good,
                                      bias=good["bias"].astype(np.float64)))
