"""Fault C4 on the CPU: the port's plain 2-bit compress and decompress in
float16 and bfloat16 bit for bit against the JAX package's XLA compress
(``mxnet_tpu/kernels/twobit.py:_xla_compress``, the route its store takes
for a half-precision key) and its Pallas decompress (``_kernel_decompress``
in interpret mode) and XLA decompress, at thresholds 0.5, 0.1 and 0.3
with gradients at, between and beyond the rounded and the exact
threshold; the threshold's rounding; and the values of fault C4's
reproduction (``tests/test_torch_card.py``) against the JAX store.

The JAX package rounds the Python threshold to float32 first and then to
the half type on its XLA route (64-bit mode off), also where rounding
once would differ (``1 + 2**-11 + 2**-40`` in float16 becomes 1.0); its
interpret-mode Pallas decompress rounds a float16 threshold once
instead. The port follows the store's route; at 0.5, 0.1 and 0.3 the
three agree.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.kernels import twobit as jtwobit
from mxnet_tpu_torch.kernels import twobit
from test_torch_card import C4_CODES, C4_RESIDUAL, C4_THR, c4_grads, \
    c4_port_run

DTYPES = {"float16": (torch.float16, jnp.float16),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# thresholds whose float32-then-half rounding differs from rounding once
TIES = {"float16": 1 + 2 ** -11 + 2 ** -40, "bfloat16": 1 + 2 ** -8 + 2 ** -40}


def _bits(t):
    """The raw 16 bits of a half-precision tensor or array."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


def _grads(thr, tdtype, seed):
    """Gradients at +-thr rounded to the dtype, +-thr exact, just inside
    and outside, and normal draws; residuals including exact zeros."""
    t = twobit.round_threshold(thr, tdtype)
    step = abs(t) * 2 ** -8
    edge = np.array([t, -t, thr, -thr, t - step, t + step, -t + step,
                     -t - step, 0.0, 1.0, -1.0], np.float64)
    rs = np.random.RandomState(seed)
    g = np.concatenate([edge, rs.randn(5000) * thr]).astype(np.float32)
    r = (rs.randn(g.size) * thr * 0.4).astype(np.float32)
    r[:edge.size] = 0
    return (torch.from_numpy(g).to(tdtype), torch.from_numpy(r).to(tdtype))


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("thr", [0.5, 0.1, 0.3, "tie"])
def test_plain_half_compress_is_bitwise_the_jax_xla_compress(name, thr):
    tdtype, jdtype = DTYPES[name]
    thr = TIES[name] if thr == "tie" else thr
    g, r = _grads(thr, tdtype, seed=len(name))
    codes, res = twobit.twobit_compress_plain(g, r, thr)
    jcodes, jres = jtwobit._xla_compress(
        jnp.asarray(g.float().numpy()).astype(jdtype),
        jnp.asarray(r.float().numpy()).astype(jdtype), thr)
    assert codes.dtype == torch.int8 and res.dtype == tdtype
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(_bits(res), _bits(jres))
    assert (codes != 0).sum() > 100


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("thr", [0.5, 0.1, 0.3])
@pytest.mark.parametrize("code_dtype", [np.int8, np.int32])
def test_plain_half_decompress_is_bitwise_the_jax_kernel(name, thr,
                                                         code_dtype):
    tdtype, jdtype = DTYPES[name]
    rs = np.random.RandomState(3)
    codes = rs.randint(-4, 5, 4099).astype(code_dtype)
    if code_dtype == np.int32:
        codes[:3] = [70000, -300, 257]   # sums a half cannot hold exactly
    got = twobit.twobit_decompress_plain(torch.from_numpy(codes), thr,
                                         tdtype)
    assert got.dtype == tdtype
    want = jtwobit._kernel_decompress(jnp.asarray(codes), thr, jdtype,
                                      interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got), _bits(jtwobit._xla_decompress(jnp.asarray(codes), thr,
                                                  jdtype)))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_at_a_tie_the_threshold_rounds_through_float32_as_the_store(name):
    tdtype, jdtype = DTYPES[name]
    thr = TIES[name]
    assert twobit.round_threshold(thr, tdtype) == 1.0
    one = torch.ones(1, dtype=torch.int8)
    got = twobit.twobit_decompress_plain(one, thr, tdtype)
    want = jtwobit._xla_decompress(jnp.asarray(one.numpy()), thr, jdtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert float(got) == 1.0


def test_round_threshold_is_float32_then_the_dtype():
    rs = np.random.RandomState(0)
    xs = np.concatenate([rs.randn(20000) * 10.0 ** rs.randint(-8, 8, 20000),
                         [0.1, 0.3, 0.5, 65519.0, 65520.0, 1e39, 0.0]])
    for x in xs:
        with np.errstate(over="ignore"):
            x32 = np.float32(x)
            half = float(x32.astype(np.float16))
        assert twobit.round_threshold(x, torch.float32) == float(x32)
        assert twobit.round_threshold(x, torch.float16) == half
        assert twobit.round_threshold(x, torch.bfloat16) == \
            float(x32.astype(ml_dtypes.bfloat16))


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_c4_reproduction_values_are_the_jax_stores(monkeypatch, dtype):
    """The constants the card test holds the card to are the JAX store's
    values under the same pushes, and the port's CPU run gives them."""
    monkeypatch.setenv("MXNET_TPU_BUCKET_BYTES", str(4 << 20))
    jkv = jmx.kv.create("dist_sync")
    jkv.set_gradient_compression({"type": "2bit", "threshold": C4_THR})
    jkv._procs = 2
    jkv._dispatch_bucket = lambda raw, mode: raw
    jkv.init(0, jmx.nd.zeros((4, 4), dtype=dtype))
    prev = np.zeros((4, 4))
    for g, want in zip(c4_grads(), C4_CODES):
        jkv.push(0, jmx.nd.array(g, dtype=dtype))
        out = jmx.nd.zeros((4, 4), dtype=dtype)
        jkv.pull(0, out=out)
        now = out.asnumpy().astype(np.float64)
        # the JAX store's pull adds each round to the stored value
        # (ROADMAP.md C1); the values are small multiples of 0.5: exact
        np.testing.assert_array_equal((now - prev) / C4_THR, want)
        prev = now
    np.testing.assert_array_equal(
        np.asarray(jkv._residuals[0]).astype(np.float64),
        np.asarray(C4_RESIDUAL[dtype]))
    rounds, res = c4_port_run(mx.cpu(), dtype)
    for got, want in zip(rounds, C4_CODES):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(res, np.asarray(C4_RESIDUAL[dtype]))


def test_a_bfloat16_key_registers_without_numpys_bfloat16():
    """The bucket plan sized a key by numpy's dtype, which knows bfloat16
    only once ``ml_dtypes`` is imported (JAX imports it; a machine with
    only PyTorch does not): a bfloat16 key of a ``dist_sync`` store then
    raised at ``init``. A process that imports only the port runs fault
    C4's bfloat16 reproduction on the CPU to the JAX store's values."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import mxnet_tpu_torch as mx\n"
        "from test_torch_card import C4_CODES, C4_RESIDUAL, c4_port_run\n"
        "assert 'ml_dtypes' not in sys.modules and 'jax' not in sys.modules\n"
        "rounds, res = c4_port_run(mx.cpu(), 'bfloat16')\n"
        "assert all(np.array_equal(g, w) for g, w in zip(rounds, C4_CODES))\n"
        "assert np.array_equal(res, np.asarray(C4_RESIDUAL['bfloat16']))\n")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root), str(root / "tests")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
