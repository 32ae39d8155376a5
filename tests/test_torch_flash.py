"""The port's flash attention (mxnet_tpu_torch/kernels/flash.py) against
the JAX package's: the plain PyTorch version against
``flash_attention_reference`` and against the Pallas kernel run in
interpret mode, the CPU dispatch rule, the CUDA wrapper's checks, and
(marked ``gpu``) the hand-written kernel against the plain version on a
card. The JAX package is imported by the tests that use it, so that the
card tests also run where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_flash.py
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import kernels, nd
from mxnet_tpu_torch import cpu as torch_cpu
from mxnet_tpu_torch.kernels import flash

# f32 on the CPU: the two frameworks sum in different orders
RTOL, ATOL = 1e-4, 1e-5


def _qkv(b, h, sq, sk, d, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, h, s, d) * 0.5).astype(np.float32)
            for s in (sq, sk, sk)]


def _jax():
    import jax.numpy as jnp
    from mxnet_tpu.kernels import flash as jflash

    return jnp, jflash


def _plain(q, k, v, scale, causal):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return flash.flash_attention_plain(*t, scale, causal).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 256])
def test_plain_matches_reference_and_pallas_kernel(seq, causal):
    jnp, jflash = _jax()
    q, k, v = _qkv(1, 2, seq, seq, 64)
    scale = 1.0 / 8.0
    got = _plain(q, k, v, scale, causal)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = jflash.flash_attention_reference(jq, jk, jv, scale, causal)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
    pallas = jflash.flash_forward(jq, jk, jv, scale, causal, 128, 128,
                                  interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("sq,sk,causal", [(100, 100, False),
                                          (100, 100, True),
                                          (128, 256, False),
                                          (96, 40, True)])
def test_plain_ragged_and_cross_match_reference(sq, sk, causal):
    jnp, jflash = _jax()
    q, k, v = _qkv(2, 3, sq, sk, 64, seed=1)
    scale = 0.125
    got = _plain(q, k, v, scale, causal)
    ref = jflash.flash_attention_reference(
        *(jnp.asarray(a) for a in (q, k, v)), scale, causal)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_op_on_cpu_takes_plain_version_and_counts_no_launch():
    q, k, v = _qkv(2, 2, 16, 16, 8, seed=2)
    before = kernels.launch_counts()["flash_attention"]
    out = nd.contrib.flash_attention(
        *(nd.array(a, ctx=torch_cpu()) for a in (q, k, v)))
    np.testing.assert_allclose(out.asnumpy(),
                               _plain(q, k, v, 1 / math.sqrt(8), False),
                               rtol=0, atol=0)
    assert kernels.launch_counts()["flash_attention"] == before


def test_op_rejects_wrong_rank():
    x = nd.array(np.zeros((2, 4, 8), np.float32), ctx=torch_cpu())
    with pytest.raises(ValueError, match="rank 3"):
        nd.contrib.flash_attention(x, x, x)


def test_cuda_wrapper_refuses_cpu_tensors_and_mixed_dispatch():
    q = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_forward(q, q, q, 1.0, False)
    meta = torch.zeros(1, 1, 8, 8, device="meta")
    with pytest.raises(Exception, match="devices"):
        kernels.dispatch("flash_attention", q, meta, q, 1.0)
    assert kernels.entry("flash_attention").replaces == \
        "mxnet_tpu/kernels/flash.py:_flash_kernel"


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: "
                    "python -m pytest -m gpu tests/test_torch_flash.py)")
    return torch.device("cuda", 0)


def _on_card(a, device, dtype, layout):
    """A numpy (B, H, S, D) array on the card in ``layout``: "dense";
    "bshd", a transposed view of a (B, S, H, D) tensor; "unaligned", rows
    starting 4 or 2 bytes off 16."""
    t = torch.from_numpy(a).to(device, dtype)
    if layout == "bshd":
        return t.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    if layout == "unaligned":
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=device)
        return buf[1:].view(t.shape).copy_(t)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,causal,layout", [
    ((4, 12, 128, 128, 64), torch.float32, False, "dense"),
    ((4, 12, 128, 128, 64), torch.float32, True, "dense"),
    ((4, 12, 128, 128, 64), torch.bfloat16, True, "dense"),
    ((2, 4, 100, 100, 64), torch.float32, True, "dense"),
    ((2, 4, 128, 256, 64), torch.float32, False, "dense"),
    ((2, 4, 128, 128, 128), torch.float32, False, "dense"),
    ((2, 4, 48, 48, 512), torch.bfloat16, False, "dense"),
    ((2, 3, 40, 40, 8), torch.float32, True, "dense"),
    ((2, 4, 96, 80, 40), torch.float32, True, "dense"),
    ((2, 4, 64, 64, 256), torch.float32, False, "dense"),
    ((2, 4, 48, 48, 512), torch.float32, True, "dense"),
    ((4, 12, 128, 128, 64), torch.float32, False, "bshd"),
    ((4, 12, 128, 128, 64), torch.bfloat16, True, "bshd"),
    ((2, 4, 100, 100, 128), torch.float32, True, "bshd"),
    ((2, 4, 33, 33, 8), torch.bfloat16, False, "bshd"),
    ((2, 4, 64, 64, 256), torch.float32, False, "bshd"),
    ((2, 4, 128, 128, 64), torch.float32, False, "unaligned"),
    ((2, 4, 128, 128, 64), torch.bfloat16, True, "unaligned"),
])
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype, causal,
                                      layout):
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, sq, sk, d = shape
    q, k, v = _qkv(b, h, sq, sk, d, seed=3)
    q = _on_card(q, cuda_device, dtype, layout)
    k, v = (_on_card(a, cuda_device, dtype, "bshd" if layout == "bshd"
                     else "dense") for a in (k, v))
    fwd = flash.flash_forward
    before, paths, copies = fwd.launches, dict(fwd.launches_by_path), \
        fwd.copies
    got = fwd(q, k, v, 1 / math.sqrt(d), causal)
    torch.cuda.synchronize()
    path = "mma" if d <= 128 else "simt"
    assert fwd.launches == before + 1
    assert fwd.launches_by_path[path] == paths[path] + 1
    assert fwd.copies == copies + (layout == "unaligned")
    # the output is a (B, H, S, D) view of (B, S, H, D) memory
    assert got.shape == (b, h, sq, d) and got.dtype == dtype
    assert got.permute(0, 2, 1, 3).is_contiguous()
    want = flash.flash_attention_plain(q, k, v, 1 / math.sqrt(d), causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="domain"):
        flash.flash_forward(q[..., :d - 4], k[..., :d - 4], v[..., :d - 4],
                            1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_key_order_on_a_non_symmetric_v_on_card(cuda_device, dtype,
                                                       causal):
    """v alternates in sign from key to key, grows along keys and
    columns, and q is large: a P V product that paired a probability with
    the wrong key's v row would move the output far beyond the
    tolerance."""
    b, h, s, d = 2, 4, 128, 64
    q, k, _ = _qkv(b, h, s, s, d, seed=4)
    keys = np.arange(s)[:, None]
    ramp = ((-1.0) ** keys * (1.0 + keys / s)
            + 0.1 * np.arange(d)[None, :] / d).astype(np.float32)
    v = np.broadcast_to(ramp, (b, h, s, d)).copy()
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in (q * 4.0, k, v))
    got = flash.flash_forward(q, k, v, 1 / math.sqrt(d), causal)
    want = flash.flash_attention_plain(q, k, v, 1 / math.sqrt(d), causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # the same v with its keys' order swapped in pairs is another answer
    swapped = flash.flash_attention_plain(
        q, k, v.view(b, h, s // 2, 2, d).flip(3).reshape(b, h, s, d),
        1 / math.sqrt(d), causal)
    assert (swapped.float() - want.float()).abs().max() > 10 * tol
