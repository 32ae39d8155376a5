"""The port's decode attention (mxnet_tpu_torch/kernels/decode_attention.py
and the op ``_contrib_decode_attention``) against the JAX package's: the
plain PyTorch version, ``nd.contrib.decode_attention`` and
``sym.contrib.decode_attention`` against ``decode_attention_reference``
and against the Pallas kernel run in interpret mode, float32 (2e-5) and
bfloat16 (2e-2), with ragged lengths and ``scale=None``; S not a multiple
of 128, which the Pallas kernel does not take, against the reference
only. (The CUDA kernel against the plain version runs on the card:
tests/test_torch_card.py.)"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.kernels import decode_attention as jdecode
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import decode_attention

CPU = mx.cpu()
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(b, h, s, d, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, d).astype(np.float32)
    k = rs.randn(b, h, s, d).astype(np.float32)
    v = rs.randn(b, h, s, d).astype(np.float32)
    lengths = rs.randint(1, s + 1, b).astype(np.int32)
    lengths[0], lengths[-1] = 1, s
    return q, k, v, lengths


def _jax(arrays, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v, lengths = arrays
    return (jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            jnp.asarray(lengths))


def _torch(arrays, dtype):
    tdt = getattr(torch, dtype)
    q, k, v, lengths = arrays
    return (torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
            torch.from_numpy(v).to(tdt), torch.from_numpy(lengths))


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,d", [(2, 2, 256, 64), (3, 4, 128, 32),
                                     (1, 1, 384, 128)])
def test_plain_matches_reference_and_pallas_kernel(b, h, s, d, dtype):
    arrays = _inputs(b, h, s, d, seed=s + d)
    scale = 1.0 / math.sqrt(d)
    got = decode_attention.decode_attention_plain(*_torch(arrays, dtype),
                                                  scale)
    assert got.dtype == getattr(torch, dtype)
    jargs = _jax(arrays, dtype)
    ref = jdecode.decode_attention_reference(*jargs, scale)
    _close(got.float(), jnp.asarray(ref, jnp.float32), dtype)
    pallas = jdecode._kernel(*jargs, scale, block_k=128, interpret=True)
    _close(got.float(), jnp.asarray(pallas, jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 77, 1000])
def test_plain_matches_reference_when_s_is_not_a_multiple_of_128(s, dtype):
    arrays = _inputs(3, 2, s, 16, seed=s)
    got = decode_attention.decode_attention_plain(*_torch(arrays, dtype),
                                                  0.25)
    ref = jdecode.decode_attention_reference(*_jax(arrays, dtype), 0.25)
    _close(got.float(), jnp.asarray(ref, jnp.float32), dtype)


def test_padding_past_the_length_does_not_reach_the_output():
    q, k, v, lengths = _torch(_inputs(2, 2, 256, 64, seed=5), "float32")
    lengths = torch.tensor([256, 100], dtype=torch.int32)
    base = decode_attention.decode_attention_plain(q, k, v, lengths, 0.125)
    k2, v2 = k.clone(), v.clone()
    k2[1, :, 100:], v2[1, :, 100:] = 1e4, -1e4
    moved = decode_attention.decode_attention_plain(q, k2, v2, lengths,
                                                    0.125)
    assert torch.equal(base, moved)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nd_and_sym_ops_match_the_jax_op(dtype):
    """``scale=None`` is 1/sqrt(D); ``block_k`` and ``interpret`` are
    accepted and do not change the result."""
    import mxnet_tpu as jmx

    arrays = _inputs(2, 3, 256, 32, seed=9)
    tq, tk, tv, tl = _torch(arrays, dtype)
    nds = [mx.nd.NDArray(t) for t in (tq, tk, tv, tl)]
    before = kernels.launch_counts()["decode_attention"]
    got = mx.nd.contrib.decode_attention(*nds)
    again = mx.nd.contrib.decode_attention(*nds, block_k=64, interpret=True)
    assert kernels.launch_counts()["decode_attention"] == before
    assert got.shape == (2, 3, 32) and got.dtype == getattr(torch, dtype)
    assert torch.equal(got._data, again._data)
    want = decode_attention.decode_attention_plain(tq, tk, tv, tl,
                                                   1 / math.sqrt(32))
    assert torch.equal(got._data, want)
    jargs = _jax(arrays, dtype)
    jout = jmx.nd.contrib.decode_attention(
        *(jmx.nd.NDArray(a) for a in jargs), interpret=True)
    _close(got._data.float(), jnp.asarray(jout._data, jnp.float32), dtype)

    names = ("q", "k", "v", "lengths")
    graph = mx.sym.contrib.decode_attention(*(mx.sym.var(n) for n in names))
    out = graph.eval_with(dict(zip(names, nds)))
    assert torch.equal(out._data, got._data)


def test_op_rejects_wrong_ranks():
    x = mx.nd.array(np.zeros((2, 4, 8, 8), np.float32), ctx=CPU)
    with pytest.raises(ValueError, match="ranks 4/4"):
        mx.nd.contrib.decode_attention(x, x, x, x)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v, lengths = _torch(_inputs(1, 1, 8, 8, seed=0), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.decode_attention(q, k, v, lengths, 1.0)
    assert kernels.entry("decode_attention").replaces == \
        "mxnet_tpu/kernels/decode_attention.py:_kernel"
