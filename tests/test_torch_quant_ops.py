"""The port's quantization ops (mxnet_tpu_torch/ops/quantization.py) and
the plain version of its int8 GEMM (kernels/int8_gemm.py) against the JAX
package on the same numpy inputs, on the CPU: bit for bit
(``np.array_equal``). The JAX ops run eagerly, op by op; JAX's int8 GEMM
family runs as ``tests/test_kernels.py`` runs it: the Pallas kernel in
interpret mode and its XLA baseline. The CUDA kernel is held against the
plain version on a card in tests/test_torch_card.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import kernels as jkernels
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import int8_gemm
from mxnet_tpu_torch.ops import registry as reg

RAGGED = [(m, k, n) for m in (1, 17, 129) for k in (1, 5, 130)
          for n in (1, 3, 129)]
# the edges of the card kernel's 128-row, 64/128-column, 64-byte-k tiles
RAGGED += [(127, 64, 129), (129, 48, 136), (130, 16, 8)]


def _jax(op, *arrays, **kw):
    out = jreg.get(op).fn(*(jnp.asarray(a) for a in arrays), **kw)
    return [np.asarray(o) for o in out] if isinstance(out, (tuple, list)) \
        else np.asarray(out)


def _port(op, *arrays, **kw):
    out = reg.get(op)(*(torch.from_numpy(np.array(a)) for a in arrays), **kw)
    return [o.numpy() for o in out] if isinstance(out, (tuple, list)) \
        else out.numpy()


def _equal(got, want):
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


def _gemm_inputs(m, k, n, seed, per_channel=True, big=False):
    rs = np.random.RandomState(seed)
    if big:  # rows of +-127: |acc| = 127 * 127 * k passes 2**24
        qx = np.full((m, k), 127, np.int8)
        w = np.full((n, k), 127, np.int8)
        for i in range(m):
            qx[i, :i] = 126
        for j in range(n):
            w[j, :j] = -127
    else:
        qx = rs.randint(-127, 128, (m, k)).astype(np.int8)
        w = rs.randint(-127, 128, (n, k)).astype(np.int8)
    scale = (rs.rand(n if per_channel else 1) * 1e-3 + 1e-5).astype(
        np.float32)
    bias = rs.randn(n).astype(np.float32)
    return qx, w, scale, bias


def _fused(qx, w, scale, bias):
    """``acc * scale + bias`` rounded once (a fused multiply-add), in
    float64 from the float32 operands."""
    acc = (qx.astype(np.int64) @ w.astype(np.int64).T).astype(np.float32)
    return (acc.astype(np.float64) * scale.astype(np.float64)
            + bias.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_int8_gemm_plain_is_bitwise_the_jax_kernel_and_baseline(m, k, n):
    """Ragged shapes, relu on and off, with and without bias. The port's
    plain version equals the JAX baseline ``_xla`` (run eagerly, as the
    JAX op runs it) bit for bit, and JAX's Pallas kernel in interpret
    mode everywhere except where XLA's CPU compiler fused the kernel
    body's ``acc * scale + bias`` into one multiply-add (one rounding
    instead of two): there, and only there, the kernel holds the fused
    value, one unit in the last place away. The count of such elements
    is part of the failure message."""
    qx, w, scale, bias = _gemm_inputs(m, k, n, seed=m * 1000 + k * 10 + n)
    e = jkernels.entry("int8_gemm")
    jargs = [jnp.asarray(a) for a in (qx, w, scale)]
    for relu, b in ((False, bias), (True, None), (False, None)):
        got = int8_gemm.int8_gemm_plain(
            *(torch.from_numpy(a) for a in (qx, w, scale)),
            bias=None if b is None else torch.from_numpy(b),
            relu=relu).numpy()
        jb = None if b is None else jnp.asarray(b)
        _equal(got, np.asarray(e.xla(*jargs, bias=jb, relu=relu)))
        kern = np.asarray(e.kernel(*jargs, bias=jb, relu=relu,
                                   interpret=True))
        differ = got != kern
        if b is None:
            assert not differ.any()
            continue
        fused = _fused(qx, w, scale, b)
        assert np.array_equal(kern[differ], fused[differ]), \
            f"{int(differ.sum())} of {got.size} elements differ, not all " \
            "by the fused multiply-add"
    assert got.shape == (m, n)


@pytest.mark.parametrize("per_channel", [True, False])
def test_int8_gemm_plain_rounds_large_sums_as_xla(per_channel):
    """|acc| up to 127 * 127 * 3072 = 4.95e7 > 2**24: the int32 -> float32
    conversion rounds to nearest even in both packages."""
    qx, w, scale, bias = _gemm_inputs(40, 3072, 48, seed=3,
                                      per_channel=per_channel, big=True)
    acc = qx.astype(np.int64) @ w.astype(np.int64).T
    assert np.abs(acc).max() > 2 ** 24
    got = int8_gemm.int8_gemm_plain(
        *(torch.from_numpy(a) for a in (qx, w, scale, bias[None])))
    want = jkernels.entry("int8_gemm").xla(
        *(jnp.asarray(a) for a in (qx, w, scale, bias[None])))
    _equal(got.numpy(), np.asarray(want))


def test_launch_counts_list_int8_gemm_paths_and_reset_zeroes_them():
    """The kernel wrapper counts its launches in total and by path (the
    cp.async path and the staged one); ``launch_counts`` lists the paths
    as ``int8_gemm.<path>`` and ``reset_launch_counts`` zeroes them."""
    k = int8_gemm.int8_gemm
    saved = k.launches, dict(k.launches_by_path)
    try:
        k.launches, k.launches_by_path["async"] = 3, 2
        k.launches_by_path["staged"] = 1
        counts = kernels.launch_counts()
        assert (counts["int8_gemm"], counts["int8_gemm.async"],
                counts["int8_gemm.staged"]) == (3, 2, 1)
        kernels.reset_launch_counts()
        counts = kernels.launch_counts()
        assert (counts["int8_gemm"], counts["int8_gemm.async"],
                counts["int8_gemm.staged"]) == (0, 0, 0)
    finally:
        k.launches = saved[0]
        k.launches_by_path.update(saved[1])


def test_dispatch_sends_cpu_tensors_to_the_plain_version():
    qx, w, scale, bias = _gemm_inputs(17, 5, 3, seed=1)
    before = kernels.launch_counts()["int8_gemm"]
    got = kernels.dispatch("int8_gemm", *(torch.from_numpy(a)
                                          for a in (qx, w, scale)),
                           bias=torch.from_numpy(bias))
    assert kernels.launch_counts()["int8_gemm"] == before
    want = int8_gemm.int8_gemm_plain(
        *(torch.from_numpy(a) for a in (qx, w, scale)),
        bias=torch.from_numpy(bias))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA card"):
        int8_gemm.int8_gemm(*(torch.from_numpy(a) for a in (qx, w, scale)))
    with pytest.raises(ValueError, match="weight"):
        int8_gemm.int8_gemm(torch.from_numpy(qx), torch.from_numpy(w[:, :4]),
                            torch.from_numpy(scale))


@pytest.mark.parametrize("calibrated", [True, False])
def test_quantize_v2_dequantize_are_bitwise_the_jax_ops(calibrated):
    x = (np.random.RandomState(2).randn(8, 33) * 3).astype(np.float32)
    x[0, :4] = [0.5, 1.5, -2.5, 0.0]  # ties at the scale of 1
    kw = {"min_calib_range": -4.2, "max_calib_range": 3.7} if calibrated \
        else {}
    got = _port("_contrib_quantize_v2", x, **kw)
    want = _jax("_contrib_quantize_v2", x, **kw)
    _equal(got, want)
    assert got[0].dtype == np.int8
    mins, maxs = np.float32([-127.0]), np.float32([127.0])
    _equal(_port("_contrib_quantize", x, mins, maxs),
           _jax("_contrib_quantize", x, mins, maxs))
    q, lo, hi = want
    _equal(_port("_contrib_dequantize", q, lo, hi),
           _jax("_contrib_dequantize", q, lo, hi))
    zero = np.zeros((), np.float32)  # an all-zero range: scale 1
    _equal(_port("_contrib_dequantize", q, zero, zero),
           _jax("_contrib_dequantize", q, zero, zero))


def test_quantized_embedding_is_bitwise_the_jax_op():
    rs = np.random.RandomState(4)
    table = rs.randint(-127, 128, (50, 12)).astype(np.int8)
    ids = rs.randint(0, 50, (3, 7)).astype(np.float32)
    lo, hi = np.float32([-0.7]), np.float32([0.7])
    kw = {"input_dim": 50, "output_dim": 12}
    got = _port("_contrib_quantized_embedding", ids, table, lo, hi, **kw)
    want = _jax("_contrib_quantized_embedding", ids, table, lo, hi, **kw)
    _equal(got, want)
    _equal(_port("_contrib_dequantize", *got),
           _jax("_contrib_dequantize", *want))


def _fc_inputs(shape, n, seed, per_channel, flatten, big=False):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 2).astype(np.float32)
    if big:  # every activation code at +-127: |acc| passes 2**24
        x = np.sign(x).astype(np.float32) * 2.0
    k = int(np.prod(shape[1:])) if flatten else shape[-1]
    w = rs.randint(-127, 128, (n, k)).astype(np.int8)
    if big:
        w = np.full((n, k), 127, np.int8)
        w[:, : n] = -127
    scale = (rs.rand(n if per_channel else 1) * 1e-2 + 1e-4).astype(
        np.float32)
    bias = rs.randn(n).astype(np.float32)
    return x, w, scale, bias


@pytest.mark.parametrize("shape,flatten", [
    ((6, 40), True), ((4, 5, 40), False), ((3, 4, 10), True),
    ((2, 64, 3072), False)])
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("use_bias", [True, False])
def test_quantized_fully_connected_is_bitwise_the_jax_op(
        shape, flatten, per_channel, use_bias):
    """2-D data (JAX: its int8 GEMM family) and 3-D data (JAX:
    ``dot_general``; the port: the same family on flattened rows), with
    and without bias, channel-wise and tensor-wise weight scales; the
    (2, 64, 3072) case has |acc| above 2**24."""
    n = 24
    x, w, scale, bias = _fc_inputs(shape, n, seed=sum(shape) + n,
                                   per_channel=per_channel,
                                   flatten=flatten, big=shape[-1] == 3072)
    kw = dict(num_hidden=n, flatten=flatten, no_bias=not use_bias,
              min_calib_range=float(x.min()),
              max_calib_range=float(x.max()))
    arrays = (x, w, scale, bias) if use_bias else (x, w, scale)
    got = _port("_contrib_quantized_fully_connected", *arrays, **kw)
    want = _jax("_contrib_quantized_fully_connected", *arrays, **kw)
    _equal(got, want)
    lead = shape[:1] if flatten else shape[:-1]
    assert got.shape == lead + (n,)
