"""The port's flash-attention backward (mxnet_tpu_torch/kernels/flash.py)
against the JAX package's: the plain dense recompute against the JAX
blocked backward ``_flash_backward`` and against ``jax.grad`` of
``flash_attention_reference``, and torch autograd through
``nd.contrib.flash_attention`` (the autograd function that calls the
backward families) on the CPU. The CUDA kernels are held against the
plain versions on a card in tests/test_torch_card.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.kernels import flash as jflash
from mxnet_tpu_torch import kernels, nd
from mxnet_tpu_torch.kernels import flash

# float32 on the CPU, two frameworks summing in different orders
TOL = 2e-5
CASES = [(2, 3, 32, 32, 16, False), (2, 3, 32, 32, 16, True),
         (1, 2, 16, 48, 8, False), (1, 2, 48, 16, 8, True),
         (2, 2, 24, 24, 64, True)]


def _inputs(b, h, sq, sk, d, seed):
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, h, s, d) * 0.5).astype(np.float32)
            for s in (sq, sk, sk, sq)]


def _jax_grads(q, k, v, do, scale, causal):
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    out = jflash.flash_attention_reference(jq, jk, jv, scale, causal)
    blocked = jflash._flash_backward(jq, jk, jv, out, jdo, scale, causal, 8,
                                     8)

    def loss(a, b, c):
        o = jflash.flash_attention_reference(a, b, c, scale, causal)
        return jnp.sum(o * jdo)

    dense = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    return np.array(out), [np.array(g) for g in blocked], \
        [np.array(g) for g in dense]


@pytest.mark.parametrize("b,h,sq,sk,d,causal", CASES)
def test_plain_backward_matches_jax_backward_and_grad(b, h, sq, sk, d,
                                                      causal):
    q, k, v, do = _inputs(b, h, sq, sk, d, seed=sq + sk)
    scale = 1.0 / np.sqrt(d)
    out, blocked, dense = _jax_grads(q, k, v, do, scale, causal)
    got = flash.flash_backward_plain(
        *(torch.from_numpy(a) for a in (q, k, v, out, do)), scale, causal)
    for g, want_b, want_d in zip(got, blocked, dense):
        np.testing.assert_allclose(g.numpy(), want_b, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g.numpy(), want_d, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,h,sq,sk,d,causal", CASES)
def test_autograd_through_the_attention_op_matches_jax(b, h, sq, sk, d,
                                                       causal):
    q, k, v, do = _inputs(b, h, sq, sk, d, seed=sq * sk)
    scale = 1.0 / np.sqrt(d)
    out, _, dense = _jax_grads(q, k, v, do, scale, causal)
    arrays = [mx.nd.array(a, ctx=mx.cpu()) for a in (q, k, v)]
    for a in arrays:
        a.attach_grad()
    counts = kernels.launch_counts()
    with mx.autograd.record():
        o = nd.contrib.flash_attention(*arrays, causal=causal)
    assert o._data.grad_fn.name().startswith("FlashAttentionFunction")
    o.backward(mx.nd.array(do, ctx=mx.cpu()))
    assert kernels.launch_counts() == counts  # CPU: the plain versions
    np.testing.assert_allclose(o.asnumpy(), out, rtol=TOL, atol=TOL)
    for a, want in zip(arrays, dense):
        np.testing.assert_allclose(a.grad.asnumpy(), want, rtol=TOL, atol=TOL)


def test_forward_log_sum_exp_and_the_families():
    q, k, v, do = _inputs(1, 2, 12, 20, 8, seed=4)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out, lse = flash.flash_attention_plain(*t, 0.3, True, with_lse=True)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * 0.3
    s = np.where(np.tril(np.ones((12, 20), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(out, flash.flash_attention_plain(*t, 0.3, True))
    dq, dsum = flash.flash_backward_dq_plain(*t, out, lse,
                                             torch.from_numpy(do), 0.3, True)
    np.testing.assert_allclose(dsum.numpy(), (do * out.numpy()).sum(-1),
                               rtol=1e-6, atol=1e-6)
    for fam in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert kernels.entry(fam).replaces == \
            "mxnet_tpu/kernels/flash.py:_flash_backward"
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_backward_dq(*t, out, lse, torch.from_numpy(do), 0.3)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_backward_dkv(*t, lse, dsum, torch.from_numpy(do), 0.3)


def test_no_graph_without_grad_and_bf16_gradients_keep_the_dtype():
    q, k, v, do = _inputs(1, 2, 16, 16, 8, seed=5)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    assert flash.flash_attention(*t, 0.5).grad_fn is None
    tb = [a.to(torch.bfloat16).requires_grad_(True) for a in t]
    o = flash.flash_attention(*tb, 0.5, causal=True)
    o.backward(torch.from_numpy(do).to(torch.bfloat16))
    want = flash.flash_backward_plain(
        *(a.detach().float() for a in tb), o.detach().float(),
        torch.from_numpy(do).to(torch.bfloat16).float(), 0.5, True)
    for a, w in zip(tb, want):
        assert a.grad.dtype == torch.bfloat16
        # bf16 inputs and output rounded once: one bf16 step (2e-2)
        np.testing.assert_allclose(a.grad.float().numpy(), w.numpy(),
                                   rtol=2e-2, atol=2e-2)
