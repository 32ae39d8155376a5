"""The port's int8 convolution (``_contrib_quantized_conv``: the int8
im2col and one ``int8_gemm`` per group, ``mxnet_tpu_torch/ops/
quantization.py``) against the JAX op (an XLA int8 convolution) on the
same numpy inputs, on the CPU, where the product runs the plain version
of the GEMM family. The CUDA kernel (K4) is held against that plain
route on a card in ``tests/test_torch_card.py``.

Tolerance: 0 ulp. The int32 sums are exact in both packages and the
float32 epilogue is the same two correctly rounded operations in the
same order (``acc * (s_x * scale) + bias``), so the outputs are equal bit
for bit; the int8 codes of the activation (``_contrib_quantize_v2`` at
the same range) are equal too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import quantization as q
from mxnet_tpu_torch.ops import registry as reg

ULP = 0

# (N, C, spatial), F, kernel, stride, pad, dilate, groups
CASES = [
    ((2, 3, 9, 11), 4, (3, 3), (1, 1), (0, 0), (1, 1), 1),
    ((2, 3, 9, 11), 4, (3, 3), (2, 2), (1, 1), (1, 1), 1),
    ((1, 4, 12, 10), 6, (3, 3), (1, 2), (2, 1), (2, 1), 1),
    ((2, 8, 7, 7), 16, (1, 1), (1, 1), (0, 0), (1, 1), 1),
    ((2, 8, 7, 7), 16, (1, 1), (2, 2), (0, 0), (1, 1), 1),
    ((1, 3, 17, 17), 8, (7, 7), (2, 2), (3, 3), (1, 1), 1),
    ((2, 4, 8, 8), 6, (3, 3), (1, 1), (1, 1), (1, 1), 2),
    ((2, 6, 8, 9), 6, (3, 3), (2, 1), (1, 1), (1, 1), 6),
    ((2, 5, 13), 4, (3,), (2,), (1,), (2,), 1),
    ((2, 4, 13), 4, (5,), (1,), (2,), (1,), 4),
    ((1, 2, 5, 6, 7), 3, (3, 3, 3), (1, 2, 1), (1, 0, 1), (1, 1, 2), 1),
    ((1, 4, 5, 5, 5), 4, (1, 1, 1), (1, 1, 1), (0, 0, 0), (1, 1, 1), 2),
]


def _inputs(case, seed, per_channel, bias):
    shape, f, kernel, _, _, _, g = case
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 0.8).astype(np.float32)
    w = rs.randint(-127, 128, (f, shape[1] // g) + kernel).astype(np.int8)
    scale = (rs.rand(f if per_channel else 1) * 1e-2 + 1e-4).astype(
        np.float32)
    b = rs.randn(f).astype(np.float32) if bias else None
    return x, w, scale, b


def _kw(case, lo, hi, bias):
    _, f, kernel, stride, pad, dilate, g = case
    return dict(kernel=kernel, stride=stride, pad=pad, dilate=dilate,
                num_filter=f, num_group=g, no_bias=not bias,
                min_calib_range=lo, max_calib_range=hi)


def _ulps(a, b):
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    ai = np.where(ai < 0, -(ai & 0x7FFFFFFF), ai)
    bi = np.where(bi < 0, -(bi & 0x7FFFFFFF), bi)
    return int(np.abs(ai - bi).max()) if a.size else 0


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(
    map(str, c[2])) + f"-s{c[3]}-p{c[4]}-d{c[5]}-g{c[6]}")
@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["channel", "tensor"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_quantized_conv_matches_jax(case, per_channel, bias):
    x, w, scale, b = _inputs(case, 0, per_channel, bias)
    lo, hi = -2.5, 2.25
    kw = _kw(case, lo, hi, bias)
    args = [x, w, scale] + ([b] if bias else [])
    want = np.asarray(jreg.get("_contrib_quantized_conv").fn(
        *(jnp.asarray(a) for a in args), **kw))
    got = reg.get("_contrib_quantized_conv")(
        *(torch.from_numpy(a) for a in args), **kw)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    got = got.contiguous().numpy()
    assert _ulps(got, want) <= ULP
    # the activation's codes, as both packages quantize it
    jq = np.asarray(jreg.get("_contrib_quantize_v2").fn(
        jnp.asarray(x), min_calib_range=lo, max_calib_range=hi)[0])
    pq = reg.get("_contrib_quantize_v2")(
        torch.from_numpy(x), min_calib_range=lo, max_calib_range=hi)[0]
    np.testing.assert_array_equal(pq.numpy(), jq)


def test_im2col_columns_run_channel_then_kernel():
    """Column ``c * k_h * k_w + i * k_w + j`` of a patch row holds input
    channel ``c`` at kernel offset ``(i, j)``, the order of
    ``weight.reshape(F, -1)``."""
    x = torch.arange(2 * 3 * 5 * 6, dtype=torch.int32).reshape(
        2, 3, 5, 6).to(torch.int8)
    cols, out = q._im2col(x, (2, 3), (1, 2), (1, 1), (0, 1))
    assert out == (4, 3) and cols.shape == (2 * 4 * 3, 3 * 6)
    xp = torch.nn.functional.pad(x, (1, 1, 0, 0))
    n, oh, ow = 1, 2, 1
    row = cols[n * 12 + oh * 3 + ow]
    for c in range(3):
        for i in range(2):
            for j in range(3):
                assert row[c * 6 + i * 3 + j] == xp[n, c, oh + i, ow * 2 + j]


def test_one_by_one_takes_the_channels_last_view_without_a_copy():
    """A 1x1, stride-1, unpadded kernel over channels-last codes hands the
    GEMM a view of them, and the output is a view of the product's
    channels-last rows."""
    x = torch.randint(-127, 128, (2, 16, 5, 5), dtype=torch.int8).to(
        memory_format=torch.channels_last)
    cols, out = q._im2col(x, (1, 1), (1, 1), (1, 1), (0, 0))
    assert cols.data_ptr() == x.data_ptr() and out == (5, 5)
    data = torch.randn(2, 16, 5, 5).to(memory_format=torch.channels_last)
    y = reg.get("_contrib_quantized_conv")(
        data, torch.ones(8, 16, 1, 1, dtype=torch.int8), torch.ones(8),
        kernel=(1, 1), num_filter=8, no_bias=True, min_calib_range=-1.0,
        max_calib_range=1.0)
    assert y.shape == (2, 8, 5, 5)
    assert y.is_contiguous(memory_format=torch.channels_last)
