"""The tensor-core flash-attention forward (csrc/flash_attention.cu), the
parts that can be checked without a card:

* its numeric scheme, emulated on the CPU: operands rounded to TF32 as
  ``cvt.rna.tf32.f32`` does, Q K^T and P V each as three TF32 products
  (small terms first) accumulated in float64, held against the port's
  plain version and the JAX package's ``flash_attention_reference``; and
  one TF32 product alone, which is not accurate enough;
* the key relabelling that lets P pass from the QK^T accumulator to the
  A operand of P V without a shuffle, emulated on the m16n8k8 fragment
  index maps;
* the op on strided (B, H, S, D) views of (B, S, H, D) activations, as
  MultiHeadAttention hands them over, against the JAX package; and which
  views the kernel's wrapper reads in place.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.kernels import flash as jflash
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.kernels import flash
from mxnet_tpu_torch.ndarray.ndarray import NDArray

KERNEL_TOL = 2e-5        # the kernel's float32 contract (rtol = atol)
RTOL, ATOL = 1e-4, 1e-5  # port vs JAX on the CPU, as tests/test_torch_flash.py


def tf32(x):
    """float32 -> TF32 (10 explicit mantissa bits) rounded to nearest,
    ties away from zero, on the float32 bits: what ``cvt.rna.tf32.f32``
    gives (inf and NaN pass)."""
    x = np.asarray(x, dtype=np.float32)
    bits = x.view(np.uint32)
    finite = np.isfinite(x)
    rounded = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000))
    return np.where(finite, rounded, bits).astype(np.uint32).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(np.asarray(x, np.float32) - hi)


def product(a, b, three=True):
    """a @ b with float32 operands as the kernel's mma computes it:
    hi_a hi_b + (hi_a lo_b + lo_a hi_b), in float64; ``three=False`` is
    one TF32 product."""
    ah, al = split(a)
    bh, bl = split(b)
    f = np.float64
    if not three:
        return ah.astype(f) @ bh.astype(f)
    small = ah.astype(f) @ bl.astype(f) + al.astype(f) @ bh.astype(f)
    return small + ah.astype(f) @ bh.astype(f)


def emulated_attention(q, k, v, scale, causal, three=True):
    """(B, H, Sq, D) attention with the kernel's products; the softmax in
    float32 as the kernel's (one pass: the online rescaling is exact up
    to float32 rounding)."""
    s = product(q, np.swapaxes(k, -1, -2), three).astype(np.float32) * \
        np.float32(scale)
    if causal:
        sq, sk = s.shape[-2:]
        s = np.where(np.tril(np.ones((sq, sk), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m).astype(np.float32)
    l = p.sum(-1, keepdims=True, dtype=np.float32)
    return (product(p, v, three) / l).astype(np.float32)


def _qkv(b, h, sq, sk, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk)]


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)       # TF32's step at 1.0
    half = np.float32(2.0 ** -11)
    below = np.nextafter(one + half, np.float32(0))
    x = np.array([one + half, -(one + half), below, one + ulp + half,
                  np.inf, -np.inf], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + 2 * ulp, np.inf,
                     -np.inf], np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    assert np.isnan(tf32(np.float32(np.nan)))
    # hi + lo carries x to about float32 precision
    x = np.random.RandomState(0).randn(10000).astype(np.float32)
    hi, lo = split(x)
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0)
    assert np.all(lo.view(np.uint32) & 0x1FFF == 0)
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() < 2.0 ** -21
    assert (np.abs(hi - x) / np.abs(x)).max() > 2.0 ** -13


@pytest.mark.parametrize("sq,sk,causal", [(64, 64, False), (64, 64, True),
                                          (100, 100, True), (96, 80, False),
                                          (40, 72, False)])
def test_three_tf32_products_meet_the_float32_contract(sq, sk, causal):
    q, k, v = _qkv(2, 3, sq, sk, 64, seed=sq + sk)
    scale = 0.125
    got = emulated_attention(q, k, v, scale, causal)
    plain = flash.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), scale, causal).numpy()
    ref = np.asarray(jflash.flash_attention_reference(
        *(jnp.asarray(a) for a in (q, k, v)), scale, causal))
    for want in (plain, ref):
        np.testing.assert_allclose(got, want, rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_product_misses_the_float32_contract(causal):
    q, k, v = _qkv(2, 3, 64, 64, 64, seed=7)
    plain = flash.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), 0.125, causal).numpy()
    one = emulated_attention(q, k, v, 0.125, causal, three=False)
    err = np.abs(one - plain) - KERNEL_TOL * np.abs(plain)
    assert err.max() > KERNEL_TOL
    three = emulated_attention(q, k, v, 0.125, causal)
    assert (np.abs(three - plain) - KERNEL_TOL * np.abs(plain)).max() < \
        KERNEL_TOL


# m16n8k8 TF32 fragments, lane = 4 g + t
def _c_position(lane, i):
    """(row, column) of accumulator register c_i."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (i >> 1), 2 * t + (i & 1)


def _a_position(lane, i):
    """(row, k) of A register a_i."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (i & 1), t + 4 * (i >> 1)


def _b_position(lane, j):
    """(k, n) of B register b_j."""
    g, t = lane >> 2, lane & 3
    return t + 4 * j, g


A_FROM_C = (0, 2, 1, 3)          # a0 = c0, a1 = c2, a2 = c1, a3 = c3


def _b_key(lane, j):
    """The V row (key of the 8-key block) that b_j reads: 2t, 2t + 1."""
    return 2 * (lane & 3) + j


def _relabelled(a_from_c):
    """For each A position (row, k): the row and key of the probability
    that a lane puts there. For each B position (k, n): the V row it
    reads."""
    a_key, b_key = {}, {}
    for lane in range(32):
        for i in range(4):
            pos = _a_position(lane, i)
            assert pos not in a_key
            a_key[pos] = _c_position(lane, a_from_c[i])
        for j in range(2):
            pos = _b_position(lane, j)
            assert pos not in b_key
            b_key[pos] = _b_key(lane, j)
    return a_key, b_key


def test_key_relabelling_pairs_each_probability_with_its_v_row():
    a_key, b_key = _relabelled(A_FROM_C)
    assert len(a_key) == 16 * 8 and len(b_key) == 8 * 8
    for row in range(16):
        for n in range(8):
            # mma sums over k: A[row, k] * B[k, n]
            keys_a = [a_key[(row, k)] for k in range(8)]
            keys_b = [b_key[(k, n)] for k in range(8)]
            assert all(r == row for r, _ in keys_a)   # no row moves
            assert sorted(key for _, key in keys_a) == list(range(8))
            assert [key for _, key in keys_a] == keys_b
    # numerically: P (16 x 8) and V (8 x 8) through the fragments
    rs = np.random.RandomState(0)
    p, v = rs.rand(16, 8), rs.randn(8, 8)

    def mma(a_from_c):
        a_key, b_key = _relabelled(a_from_c)
        out = np.zeros((16, 8))
        for (row, k), (r, key) in a_key.items():
            for n in range(8):
                out[row, n] += p[r, key] * v[b_key[(k, n)], n]
        return out

    np.testing.assert_allclose(mma(A_FROM_C), p @ v, rtol=1e-12)
    # the accumulator taken as it is (a_i = c_i) is another product
    assert np.abs(mma((0, 1, 2, 3)) - p @ v).max() > 0.1


def _bshd_views(arrays):
    """(B, S, H, D) tensors of the (B, H, S, D) numpy arrays, and their
    (B, H, S, D) views: MultiHeadAttention's split."""
    return [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
            .permute(0, 2, 1, 3) for a in arrays]


@pytest.mark.parametrize("sq,sk,d,causal", [(16, 16, 64, False),
                                            (33, 33, 64, True),
                                            (24, 40, 40, False),
                                            (20, 20, 128, True)])
def test_op_on_strided_views_matches_jax(sq, sk, d, causal):
    q, k, v = (a * 0.5 for a in _qkv(2, 3, sq, sk, d, seed=d))
    views = _bshd_views((q, k, v))
    assert not views[0].is_contiguous()
    out = nd.contrib.flash_attention(*(NDArray(t) for t in views),
                                     causal=causal)
    ref = jflash.flash_attention_reference(
        *(jnp.asarray(a) for a in (q, k, v)), 1 / np.sqrt(d), causal)
    np.testing.assert_allclose(out.asnumpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_wrapper_reads_transposed_views_in_place_and_copies_the_rest():
    """The kernel reads a (B, H, S, D) operand through its strides when D's
    stride is 1 and every row starts on 16 bytes."""
    f32 = torch.zeros(2, 16, 3, 64)              # (B, S, H, D)
    assert flash._readable(f32.permute(0, 2, 1, 3))
    assert flash._readable(torch.zeros(2, 3, 16, 64))
    bf16 = torch.zeros(2, 16, 3, 8, dtype=torch.bfloat16)
    assert flash._readable(bf16.permute(0, 2, 1, 3))
    # D not contiguous
    assert not flash._readable(torch.zeros(2, 3, 64, 16).transpose(2, 3))
    # rows 4 bytes off 16: by the pointer, or by a stride of 73 floats
    buf = torch.zeros(2 * 3 * 16 * 64 + 1)
    assert not flash._readable(buf[1:].view(2, 3, 16, 64))
    assert not flash._readable(torch.zeros(2 * 3 * 16 * 73).as_strided(
        (2, 3, 16, 64), (3 * 16 * 73, 16 * 73, 73, 1)))
    # a dim of length 1 may have any stride
    one = torch.zeros(1, 16, 1, 64).as_strided((1, 1, 16, 64),
                                               (7, 5, 64, 1))
    assert flash._readable(one)
