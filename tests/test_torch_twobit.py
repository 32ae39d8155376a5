"""The port's 2-bit gradient compression (mxnet_tpu_torch/kernels/twobit.py)
against the JAX package's: the plain PyTorch compress and decompress bit
for bit against ``_xla_compress`` / ``_xla_decompress`` and against the
Pallas kernels run in interpret mode, on seeded inputs, values exactly at
+-thr, odd sizes and summed codes; the CPU dispatch rule and the CUDA
wrappers' checks. (The CUDA kernels against the plain versions run on the
card: tests/test_torch_card.py.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.kernels import twobit as jtwobit
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import twobit

SIZES = [1, 7, 127, 128, 4097, 33 * 128 + 5]


def _inputs(n, seed, thr):
    """Gradients and residuals from a normal distribution, with the first
    elements placed exactly at +-thr, just inside and outside them, and
    a residual that lands the sum on +-thr."""
    rs = np.random.RandomState(seed)
    g = (rs.randn(n) * thr).astype(np.float32)
    r = (rs.randn(n) * thr * 0.5).astype(np.float32)
    t = np.float32(thr)
    edge = np.array([t, -t, np.nextafter(t, 0), np.nextafter(-t, 0),
                     np.nextafter(t, 1), 0.0, -0.0], np.float32)
    m = min(n, edge.size)
    g[:m], r[:m] = edge[:m], 0.0
    if n > 8:
        g[7], r[7] = np.float32(thr) - np.float32(0.25), np.float32(0.25)
    return g, r


def _jax_views(g, r):
    return jnp.asarray(g), jnp.asarray(r)


@pytest.mark.parametrize("thr", [0.5, 0.1, 1e-3])
@pytest.mark.parametrize("n", SIZES)
def test_plain_compress_is_bit_exact_to_xla_and_pallas(n, thr):
    g, r = _inputs(n, seed=n, thr=thr)
    codes, res = twobit.twobit_compress_plain(torch.from_numpy(g),
                                              torch.from_numpy(r), thr)
    assert codes.dtype == torch.int8 and res.dtype == torch.float32
    jg, jr = _jax_views(g, r)
    for jc, jres in (jtwobit._xla_compress(jg, jr, thr),
                     jtwobit._kernel_compress(jg, jr, thr, interpret=True)):
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(res.numpy().view(np.uint32),
                                      np.asarray(jres).view(np.uint32))


def test_compress_codes_at_the_threshold_and_nan():
    thr = 0.5
    g = torch.tensor([0.5, -0.5, 0.4999999, -0.4999999, 0.6, float("nan"),
                      0.3], dtype=torch.float32)
    r = torch.tensor([0, 0, 0, 0, -0.2, 0, 0.2], dtype=torch.float32)
    codes, res = twobit.twobit_compress_plain(g, r, thr)
    assert codes.tolist() == [1, -1, 0, 0, 0, 0, 1]
    assert torch.isnan(res[5]) and res[0] == 0 and res[1] == 0
    jc, jres = jtwobit._xla_compress(jnp.asarray(g.numpy()),
                                     jnp.asarray(r.numpy()), thr)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))


@pytest.mark.parametrize("thr", [0.5, 0.1])
@pytest.mark.parametrize("n", SIZES)
def test_plain_decompress_of_summed_codes_is_bit_exact(n, thr):
    rs = np.random.RandomState(n + 1)
    for lo, hi, dtype in ((-1, 1, np.int8), (-2, 2, np.int8),
                          (-4, 4, np.int32)):
        c = rs.randint(lo, hi + 1, n).astype(dtype)
        got = twobit.twobit_decompress_plain(torch.from_numpy(c), thr)
        assert got.dtype == torch.float32
        jc = jnp.asarray(c)
        for want in (jtwobit._xla_decompress(jc, thr),
                     jtwobit._kernel_decompress(jc, thr, interpret=True)):
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(want).view(np.uint32))


def test_error_feedback_over_rounds_matches_jax():
    """Three rounds of compress with the residual carried: the port's
    plain version and JAX's stay bit-identical."""
    rs = np.random.RandomState(3)
    res_t, res_j = torch.zeros(500), jnp.zeros(500, jnp.float32)
    for _ in range(3):
        g = (rs.randn(500) * 0.3).astype(np.float32)
        c_t, res_t = twobit.twobit_compress_plain(torch.from_numpy(g), res_t,
                                                  0.5)
        c_j, res_j = jtwobit._xla_compress(jnp.asarray(g), res_j, 0.5)
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
        np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))


def test_dispatch_takes_plain_on_cpu_and_counts_no_launch():
    g, r = _inputs(64, seed=0, thr=0.5)
    before = kernels.launch_counts()
    codes, res = kernels.dispatch("twobit_compress", torch.from_numpy(g),
                                  torch.from_numpy(r), 0.5)
    out = kernels.dispatch("twobit_decompress", codes, 0.5)
    want = twobit.twobit_compress_plain(torch.from_numpy(g),
                                        torch.from_numpy(r), 0.5)
    assert torch.equal(codes, want[0]) and torch.equal(res, want[1])
    assert torch.equal(out, twobit.twobit_decompress_plain(codes, 0.5))
    assert kernels.launch_counts() == before
    assert kernels.entry("twobit_compress").replaces == \
        "mxnet_tpu/kernels/twobit.py:_kernel_compress"
    assert kernels.entry("twobit_decompress").replaces == \
        "mxnet_tpu/kernels/twobit.py:_kernel_decompress"


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    g = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        twobit.twobit_compress(g, g, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        twobit.twobit_decompress(torch.zeros(8, dtype=torch.int8), 0.5)
    meta = torch.zeros(8, device="meta")
    with pytest.raises(Exception, match="devices"):
        kernels.dispatch("twobit_compress", g, meta, 0.5)
