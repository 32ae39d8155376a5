"""The tensor-core flash-attention backward (csrc/flash_attention_bwd.cu),
the parts that can be checked without a card:

* its numeric scheme, emulated on the CPU: every product (S = Q K^T,
  dP = dO V^T, dq = dS K, dk = dS^T Q, dv = P^T dO) as three TF32
  products, small terms first, accumulated in float64; P from the saved
  log-sum-exp in base 2 and dS = P (dP - D) in float32, as the kernels
  compute them; held against the port's ``flash_backward_plain`` and the
  JAX package's ``_flash_backward``; and one TF32 product alone, which
  is not accurate enough;
* the fragment-level data flow of one warp on the m16n8k8 index maps: the
  accumulator-to-operand relabelling that takes dS to the A operand
  against K rows 2t, 2t + 1 (dq) and P^T and dS^T against dO and Q rows
  (dkv), the per-column lse and D of the dkv kernel, and the QK-shaped
  B reads of K Q^T and V dO^T;
* autograd through ``nd.contrib.flash_attention`` and a
  MultiHeadAttention, whose heads reach the op as transposed views of
  (B, S, H, D) tensors, against ``jax.grad`` of the JAX reference;
* the backward wrappers' rules: which inputs they read in place, and that
  the gradients they allocate keep their inputs' memory order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.kernels import flash as jflash
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon.contrib import nn as cnn
from mxnet_tpu_torch.kernels import flash

KERNEL_TOL = 2e-5        # the kernels' float32 contract (rtol = atol)
RTOL, ATOL = 1e-4, 1e-5  # port vs JAX on the CPU through dense layers
LOG2E = np.float32(1.4426950408889634)


def tf32(x):
    """float32 -> TF32 rounded to nearest, ties away from zero, on the
    bits: the kernels' ``tf32_rna`` (inf and NaN pass)."""
    x = np.asarray(x, dtype=np.float32)
    bits = x.view(np.uint32)
    rounded = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(np.isfinite(x), rounded, bits).astype(
        np.uint32).view(np.float32)


def product(a, b, three=True):
    """a @ b with float32 operands as the kernels' mma computes it: the
    small terms hi_a lo_b + lo_a hi_b, then hi_a hi_b, in float64;
    ``three=False`` is one TF32 product."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    f = np.float64
    if not three:
        return ah.astype(f) @ bh.astype(f)
    small = ah.astype(f) @ bl.astype(f) + al.astype(f) @ bh.astype(f)
    return small + ah.astype(f) @ bh.astype(f)


def emulated_backward(q, k, v, o, lse, do, scale, causal, three=True):
    """(dq, dk, dv) as the two kernels compute them, float32 out."""
    f32 = np.float32
    t = lambda x: np.swapaxes(x, -1, -2)  # noqa: E731
    s = product(q, t(k), three).astype(f32)
    x = s * f32(scale * LOG2E) - (lse * LOG2E)[..., None]
    p = np.exp2(x).astype(f32)
    if causal:
        sq, sk = s.shape[-2:]
        p = np.where(np.tril(np.ones((sq, sk), bool)), p, f32(0))
    dsum = (do.astype(np.float64) * o).sum(-1).astype(f32)
    dp = product(do, t(v), three).astype(f32)
    ds = (p * (dp - dsum[..., None])).astype(f32)
    dq = (product(ds, k, three) * scale).astype(f32)
    dk = (product(t(ds), q, three) * scale).astype(f32)
    dv = product(t(p), do, three).astype(f32)
    return dq, dk, dv


def _inputs(b, h, sq, sk, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, s, d).astype(np.float32) for s in (sq, sk, sk, sq)]


def _plain_and_jax(q, k, v, do, scale, causal):
    """The forward's o and lse, the port's plain backward and the JAX
    package's blocked ``_flash_backward``, all from the same o."""
    t = [torch.from_numpy(a) for a in (q, k, v)]
    o, lse = flash.flash_attention_plain(*t, scale, causal, with_lse=True)
    plain = flash.flash_backward_plain(*t, o, torch.from_numpy(do), scale,
                                       causal)
    sq, sk = q.shape[2], k.shape[2]
    blocked = jflash._flash_backward(
        *(jnp.asarray(a) for a in (q, k, v, o.numpy(), do)), scale, causal,
        8 if sq % 8 == 0 else 1, 8 if sk % 8 == 0 else 1)
    return o.numpy(), lse.numpy(), [g.numpy() for g in plain], \
        [np.asarray(g) for g in blocked]


@pytest.mark.parametrize("sq,sk,causal", [(64, 64, False), (64, 64, True),
                                          (100, 100, True), (96, 80, True),
                                          (40, 72, False), (72, 40, True)])
def test_three_tf32_products_meet_the_float32_contract(sq, sk, causal):
    q, k, v, do = _inputs(2, 2, sq, sk, 64, seed=sq + 2 * sk)
    scale = 0.125
    o, lse, plain, blocked = _plain_and_jax(q, k, v, do, scale, causal)
    got = emulated_backward(q, k, v, o, lse, do, scale, causal)
    for g, p, j in zip(got, plain, blocked):
        np.testing.assert_allclose(g, p, rtol=KERNEL_TOL, atol=KERNEL_TOL)
        np.testing.assert_allclose(g, j, rtol=KERNEL_TOL, atol=KERNEL_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_product_misses_the_float32_contract(causal):
    q, k, v, do = _inputs(2, 3, 64, 64, 64, seed=11)
    o, lse, plain, _ = _plain_and_jax(q, k, v, do, 0.125, causal)

    def worst(three):
        got = emulated_backward(q, k, v, o, lse, do, 0.125, causal, three)
        return max((np.abs(g - p) - KERNEL_TOL * np.abs(p)).max()
                   for g, p in zip(got, plain))

    assert worst(False) > KERNEL_TOL
    assert worst(True) < KERNEL_TOL


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


def _mma(a_regs, b_regs, c_regs):
    """One warp's m16n8k8 mma on per-lane registers: a_regs[lane][4],
    b_regs[lane][2], c_regs[lane][4] (updated in place)."""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        for i in range(4):
            a[_a_position(lane, i)] = a_regs[lane][i]
        for j in range(2):
            b[_b_position(lane, j)] = b_regs[lane][j]
    c = a @ b
    for lane in range(32):
        for i in range(4):
            c_regs[lane][i] += c[_c_position(lane, i)]


A_FROM_C = (0, 2, 1, 3)   # the relabelling: a0 = c0, a1 = c2, a2 = c1, a3 = c3


def _qk_shaped(x, y):
    """X (16 x K) Y^T (N x K) as the kernels' qk_step computes it: A from X
    rows g, g + 8 at columns 8 kk + t, + 4; B from Y rows 8 nb + g at the
    same columns. Returns per-lane accumulators [nb][lane][4]."""
    nbs, kds = y.shape[0] // 8, x.shape[1] // 8
    acc = [[[0.0] * 4 for _ in range(32)] for _ in range(nbs)]
    for kk in range(kds):
        a_regs = []
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            a_regs.append([x[g, 8 * kk + t], x[g + 8, 8 * kk + t],
                           x[g, 8 * kk + t + 4], x[g + 8, 8 * kk + t + 4]])
        for nb in range(nbs):
            b_regs = []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                b_regs.append([y[8 * nb + g, 8 * kk + t],
                               y[8 * nb + g, 8 * kk + t + 4]])
            _mma(a_regs, b_regs, acc[nb])
    return acc


def _pv_shaped(acc, y, a_from_c=A_FROM_C):
    """sum_nb C_nb Y[8 nb: 8 nb + 8] as the kernels' pv_product computes
    it: A from the accumulator block relabelled by ``a_from_c``, B from Y
    rows 8 nb + 2t (b0) and 8 nb + 2t + 1 (b1), column 8 nd + g."""
    kds = y.shape[1] // 8
    out = [[[0.0] * 4 for _ in range(32)] for _ in range(kds)]
    for nb, c in enumerate(acc):
        a_regs = [[c[lane][a_from_c[i]] for i in range(4)]
                  for lane in range(32)]
        for nd in range(kds):
            b_regs = []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                b_regs.append([y[8 * nb + 2 * t, 8 * nd + g],
                               y[8 * nb + 2 * t + 1, 8 * nd + g]])
            _mma(a_regs, b_regs, out[nd])
    return out


def _dense(frags, rows=16):
    """Per-lane accumulators [n8 block][lane][4] as a (16, 8 n) matrix."""
    out = np.zeros((rows, 8 * len(frags)))
    for nb, c in enumerate(frags):
        for lane in range(32):
            for i in range(4):
                r, col = _c_position(lane, i)
                out[r, 8 * nb + col] = c[lane][i]
    return out


def test_dq_warp_relabels_ds_against_k_rows_2t():
    """One warp of the dq kernel: S and dP QK-shaped from Q, dO against K,
    V; P and dS per row (lse and D of rows g, g + 8); dq += dS K with dS
    relabelled and K rows 2t, 2t + 1."""
    rs = np.random.RandomState(0)
    q, do = rs.randn(16, 16), rs.randn(16, 16)
    k, v = rs.randn(32, 16), rs.randn(32, 16)
    lse, dsum = rs.randn(16) + 3.0, rs.randn(16)
    s, dp = _qk_shaped(q, k), _qk_shaped(do, v)
    np.testing.assert_allclose(_dense(s), q @ k.T, rtol=1e-12, atol=1e-12)
    ds = [[[0.0] * 4 for _ in range(32)] for _ in range(len(s))]
    for nb in range(len(s)):
        for lane in range(32):
            g = lane >> 2
            for i in range(4):
                row = g + 8 * (i >> 1)            # the statistic's row
                assert row == _c_position(lane, i)[0]
                p = np.exp(s[nb][lane][i] - lse[row])
                ds[nb][lane][i] = p * (dp[nb][lane][i] - dsum[row])
    p_dense = np.exp(q @ k.T - lse[:, None])
    ds_dense = p_dense * (do @ v.T - dsum[:, None])
    want = ds_dense @ k
    np.testing.assert_allclose(_dense(_pv_shaped(ds, k)), want, rtol=1e-12,
                               atol=1e-12)
    # the accumulator taken as it is (a_i = c_i) is another product
    assert np.abs(_dense(_pv_shaped(ds, k, (0, 1, 2, 3))) - want).max() > 0.1


def test_dkv_warp_relabels_p_and_ds_transposed_against_do_and_q_rows():
    """One warp of the dkv kernel: S^T and dP^T QK-shaped from K, V against
    Q, dO; P^T and dS^T per column (lse and D of q rows 8 nb + 2t, + 1);
    dv += P^T dO and dk += dS^T Q relabelled, B from dO and Q rows 2t,
    2t + 1; q rows past Sq give P = 0."""
    rs = np.random.RandomState(1)
    k, v = rs.randn(16, 16), rs.randn(16, 16)
    q, do = rs.randn(32, 16), rs.randn(32, 16)
    lse, dsum = rs.randn(32) + 3.0, rs.randn(32)
    valid = 27                                    # q rows past Sq: zero
    q[valid:], do[valid:], lse[valid:], dsum[valid:] = 0, 0, 0, 0
    st, dpt = _qk_shaped(k, q), _qk_shaped(v, do)
    np.testing.assert_allclose(_dense(st), k @ q.T, rtol=1e-12, atol=1e-12)
    pt = [[[0.0] * 4 for _ in range(32)] for _ in range(len(st))]
    dst = [[[0.0] * 4 for _ in range(32)] for _ in range(len(st))]
    for nb in range(len(st)):
        for lane in range(32):
            t = lane & 3
            for i in range(4):
                col = 8 * nb + 2 * t + (i & 1)    # the statistic's q row
                assert col == 8 * nb + _c_position(lane, i)[1]
                p = np.exp(st[nb][lane][i] - lse[col]) if col < valid else 0.
                pt[nb][lane][i] = p
                dst[nb][lane][i] = p * (dpt[nb][lane][i] - dsum[col])
    p_dense = np.exp(q @ k.T - lse[:, None])
    p_dense[valid:] = 0
    ds_dense = p_dense * (do @ v.T - dsum[:, None])
    np.testing.assert_allclose(_dense(_pv_shaped(pt, do)), p_dense.T @ do,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_dense(_pv_shaped(dst, q)), ds_dense.T @ q,
                               rtol=1e-12, atol=1e-12)
    # without the explicit mask the rows past Sq give P = exp(0 - 0) = 1
    assert np.exp(_dense(st)[:, valid:] - lse[valid:]).min() == 1.0


def _jax_mha_grads(x, weights, heads, causal, dy):
    """jax.grad of MultiHeadAttention written with the JAX reference
    attention: input and every weight and bias."""
    b, s, u = x.shape
    d = u // heads

    def f(x, wq, bq, wk, bk, wv, bv, wp, bp):
        def split(t):
            return t.reshape(b, s, heads, d).transpose(0, 2, 1, 3)
        att = jflash.flash_attention_reference(
            split(x @ wq.T + bq), split(x @ wk.T + bk), split(x @ wv.T + bv),
            1 / np.sqrt(d), causal)
        out = att.transpose(0, 2, 1, 3).reshape(b, s, u) @ wp.T + bp
        return jnp.sum(out * dy)

    grads = jax.grad(f, argnums=tuple(range(9)))(
        jnp.asarray(x), *(jnp.asarray(w) for w in weights))
    return [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_gradients_match_jax(causal):
    """The heads reach the attention op as transposed (B, H, S, D) views of
    the (B, S, H, D) projections, and the gradients flow back through the
    transposes; x, weight and bias gradients against jax.grad."""
    rs = np.random.RandomState(3 + causal)
    x = rs.randn(2, 24, 32).astype(np.float32)
    dy = rs.randn(2, 24, 32).astype(np.float32)
    mha = cnn.MultiHeadAttention(32, 4, causal=causal)
    mha.initialize(mx.init.Xavier(), ctx=mx.cpu(),
                   generator=torch.Generator().manual_seed(0))
    xa = mx.nd.array(x, ctx=mx.cpu())
    mha(xa)
    params = [getattr(mha, n) for n in ("query", "key", "value", "proj")]
    weights = [a for blk in params
               for a in (blk.weight.data().asnumpy(),
                         blk.bias.data().asnumpy())]
    xa.attach_grad()
    with mx.autograd.record():
        y = mha(xa)
    y.backward(mx.nd.array(dy, ctx=mx.cpu()))
    got = [xa.grad.asnumpy()] + [
        a for blk in params
        for a in (blk.weight.grad().asnumpy(), blk.bias.grad().asnumpy())]
    want = _jax_mha_grads(x, weights, 4, causal, dy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("sq,sk,d,causal", [(16, 16, 64, False),
                                            (33, 33, 64, True),
                                            (24, 40, 40, False),
                                            (20, 20, 128, True)])
def test_op_gradients_on_strided_views_match_jax(sq, sk, d, causal):
    """Leaves in (B, S, H, D), transposed into the op inside the recorded
    graph; their gradients come back in (B, S, H, D) against jax.grad of
    the reference."""
    q, k, v, do = (a * 0.5 for a in _inputs(2, 3, sq, sk, d, seed=d + sq))
    leaves = [mx.nd.array(np.ascontiguousarray(a.transpose(0, 2, 1, 3)),
                          ctx=mx.cpu()) for a in (q, k, v)]
    for a in leaves:
        a.attach_grad()
    with mx.autograd.record():
        views = [nd.transpose(a, axes=(0, 2, 1, 3)) for a in leaves]
        assert not views[0]._data.is_contiguous()
        out = nd.contrib.flash_attention(*views, causal=causal)
    out.backward(mx.nd.array(do, ctx=mx.cpu()))

    def loss(a, b, c):
        o = jflash.flash_attention_reference(a, b, c, 1 / np.sqrt(d), causal)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    for a, w in zip(leaves, want):
        np.testing.assert_allclose(a.grad.asnumpy(),
                                   np.asarray(w).transpose(0, 2, 1, 3),
                                   rtol=RTOL, atol=ATOL)


def test_backward_wrappers_read_views_in_place_and_copy_the_rest():
    """The backward kernels read q, k, v, o and dO as the forward reads
    its inputs: a transposed (B, S, H, D) view or a dense tensor in place,
    and a copy, counted, only where D's stride is not 1 or a row does not
    start on 16 bytes."""
    fn = flash.flash_backward_dq
    view = torch.zeros(2, 16, 3, 64).permute(0, 2, 1, 3)
    dense = torch.zeros(2, 3, 16, 64)
    buf = torch.zeros(2 * 3 * 16 * 64 + 1)
    unaligned = buf[1:].view(2, 3, 16, 64)
    d_strided = torch.zeros(2, 3, 64, 16).transpose(2, 3)
    before = fn.copies
    got = flash._operands(fn, view, dense, unaligned, d_strided)
    assert got[0] is view and got[1] is dense
    assert fn.copies == before + 2
    for t in got[2:]:
        assert t.is_contiguous() and t.data_ptr() % 16 == 0
        assert flash._readable(t)
    assert torch.equal(got[2], unaligned)
    # expanded dO (a sum's gradient): stride 0 over (B, H, S) is read as it
    # is, stride 0 over D is copied
    assert flash._readable(torch.ones(1, 1, 1, 64).expand(2, 3, 16, 64))
    assert not flash._readable(torch.ones(1).expand(2, 3, 16, 64))


def _grad_of(t):
    """A gradient as the backward wrappers allocate it: ``empty_like`` of
    the operand the kernel reads (``t`` itself, or its dense copy)."""
    return torch.empty_like(flash._operands(flash.flash_backward_dq, t)[0])


def test_gradients_keep_their_inputs_memory_order():
    """dq, dk and dv are allocated like their inputs: a transposed
    (B, S, H, D) view gives a gradient that is one too, so the caller's
    transpose back and reshape are views; a dense input a dense gradient;
    a view with gaps a contiguous one; an input the wrapper copies the
    copy's order. Every row starts on 16 bytes."""
    bshd = torch.zeros(2, 16, 3, 64).permute(0, 2, 1, 3)
    g = _grad_of(bshd)
    assert g.shape == bshd.shape and g.stride() == bshd.stride()
    back = g.permute(0, 2, 1, 3)
    assert back.is_contiguous()
    assert back.reshape(2, 16, 192).data_ptr() == g.data_ptr()
    dense = torch.zeros(2, 3, 16, 64, dtype=torch.bfloat16)
    assert _grad_of(dense).is_contiguous()
    gaps = torch.zeros(2, 3, 16, 72)[..., :64]
    assert flash._readable(gaps)
    g = _grad_of(gaps)
    assert g.is_contiguous() and flash._readable(g)
    assert flash._readable(_grad_of(bshd))
    d_strided = torch.zeros(2, 3, 64, 16).transpose(2, 3)
    assert not flash._readable(d_strided)
    g = _grad_of(d_strided)
    assert g.shape == d_strided.shape and g.is_contiguous()
