"""The port's flash attention (mxnet_tpu_torch/kernels/flash.py) against
the JAX package's: the plain PyTorch version against
``flash_attention_reference`` and against the Pallas kernel run in
interpret mode, the CPU dispatch rule, the CUDA wrapper's checks, and
(marked ``gpu``) the hand-written kernel against the plain version on a
card."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.kernels import flash as jflash
from mxnet_tpu_torch import kernels, nd
from mxnet_tpu_torch import cpu as torch_cpu
from mxnet_tpu_torch.kernels import flash

# f32 on the CPU: the two frameworks sum in different orders
RTOL, ATOL = 1e-4, 1e-5


def _qkv(b, h, sq, sk, d, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(b, h, s, d) * 0.5).astype(np.float32)
            for s in (sq, sk, sk)]


def _plain(q, k, v, scale, causal):
    t = [torch.from_numpy(a) for a in (q, k, v)]
    return flash.flash_attention_plain(*t, scale, causal).numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 256])
def test_plain_matches_reference_and_pallas_kernel(seq, causal):
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


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,causal", [
    ((4, 12, 128, 128, 64), torch.float32, False),
    ((4, 12, 128, 128, 64), torch.float32, True),
    ((4, 12, 128, 128, 64), torch.bfloat16, True),
    ((2, 4, 100, 100, 64), torch.float32, True),
    ((2, 4, 128, 256, 64), torch.float32, False),
    ((2, 4, 128, 128, 128), torch.float32, False),
    ((2, 4, 48, 48, 512), torch.bfloat16, False),
])
def test_kernel_matches_plain_on_card(cuda_device, shape, dtype, causal):
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, sq, sk, d = shape
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(b, h, sq, sk, d, seed=3))
    before = flash.flash_forward.launches
    got = flash.flash_forward(q, k, v, 1 / math.sqrt(d), causal)
    torch.cuda.synchronize()
    assert flash.flash_forward.launches == before + 1
    want = flash.flash_attention_plain(q, k, v, 1 / math.sqrt(d), causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="domain"):
        flash.flash_forward(q[..., :12], k[..., :12], v[..., :12], 1.0)
