"""Card tests of the port's kernels, marked ``gpu``: they skip
without a card (decided in a fixture) and import nothing of JAX, so they
run on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_card.py

* gradients through ``nd.contrib.flash_attention`` on the card come from
  the backward kernels, equal the plain dense recompute, and reach the
  q/k/v projections of a MultiHeadAttention;
* the flash backward kernels against their plain versions;
* the fused SGD-momentum and Adam kernels bit for bit against theirs,
  aligned and with one operand 4 bytes off (the scalar path), sizes up
  to 10**7 + 3, the skip flag, and two learning-rate groups through
  ``Optimizer.fused_update_multi``;
* the int8 GEMM kernel bit for bit against its plain version, and a
  quantized FullyConnected on the card equal to the same op on the CPU;
* the decode-attention kernel through ``nd.contrib.decode_attention``
  against its plain version, and the 2-bit compress and decompress
  kernels bit for bit against theirs: the single-tensor pair, and the
  multi-tensor compress and the decompress of wire ranges through the
  dist kvstore's flat layout (odd sizes, unaligned gradients, a strict subset of a
  bucket, values at +-thr and NaN), with their launches by path;
* the single-tensor compress and the decompress in float16 and bfloat16
  bit for bit against their plain versions, and fault C4's reproduction:
  a float16 or bfloat16 key of a ``dist_sync`` store under 2-bit
  compression on the card, equal to the CPU run and to the JAX store's
  values (``C4_CODES``, ``C4_RESIDUAL``; ``tests/test_torch_twobit_half.py``
  holds them against the JAX package);
* Convolution, Pooling, _contrib_AdaptiveAvgPooling2D and BatchNorm on
  the card (cuDNN, TF32 off) against the same ops on the CPU, forward and
  gradients; the ResNet path's ops on bfloat16 data against the CPU;
* bfloat16 ``ShardedTrainer`` steps on their routes (K1 over the float32
  tensors and masters, the plain op for bfloat16 weights without
  ``multi_precision``), and a bfloat16 checkpoint saved and resumed on
  the card bit for bit;
* the causal flash forward and backward at ``transformer_lm``'s
  GPT-2-small shape against their plain versions, a dropped captured
  trainer returning its graph pool without a collection (fault C10),
  and a captured ``remat`` step drawing the eager steps' Dropout masks;
* ``ServedModel.swap_params`` on a captured bucket ladder: the output
  changes, nothing is captured again and the copy runs on the replay
  stream; swaps racing replays never give a batch that matches neither
  version;
* a captured "lamb" and a captured "nadam" ``ShardedTrainer`` step
  replayed 5 times under ``torch.cuda.set_sync_debug_mode("error")`` (no
  host sync; their norms, step counts and Nadam's schedule are device
  scalars) against the same steps run eagerly; grouped ``Deconvolution``
  (and ``target_shape``) on the card against the CPU; ``CTCLoss`` on the
  card (``torch.nn.functional.ctc_loss``) against the plain recursion on
  the card and on the CPU, values and gradients;
* the samplers of ``nd.random`` inside a ``compile.jit`` graph: a replay
  from a saved generator state draws what the eager call draws from it,
  bit for bit, and the next replay draws anew; ``linalg_potrf``
  (``cholesky_ex``) of a batch with a matrix that is not positive
  definite inside a graph, under ``set_sync_debug_mode("error")``: NaN
  in that factor's lower triangle, the others right; a hybridized block
  holding a ``Custom`` op runs uncaptured, counted under its reason, with
  no capture attempted;
* ``ShardedTrainer``'s options and the telemetry stack: a captured
  step's flops (the backward's among them, counted on autograd's engine
  thread) equal the same step's count on the CPU and
  ``chip_smoke.classifier_step_flops``; ``warmup`` makes one capture and
  takes no step; the memory gauges equal ``torch.cuda.memory_stats()``;
  ``aot_lower`` on fake CUDA tensors launches no kernel;
* row-sparse and CSR arrays on the card: the dense views, ``sparse_add``,
  ``merge_duplicates``, ``retain``, ``row_sparse_pull`` and the lazy SGD
  (with momentum, weight decay and clip) bit for bit against the CPU;
  ``LibSVMIter`` batches made on the card; a row-sparse gradient pushed
  with dense ones never reaching K1 (one launch over the dense keys, the
  embedding's untouched rows and momentum unchanged).
* the int8 convolution's K4 route (``_contrib_quantized_conv``: im2col,
  one K4 launch per group) bit for bit against the same op on the CPU
  (the plain GEMM) at ResNet-50's stem (K = 147: the staged path), a 3x3
  and a 1x1 on channels-last codes (the async path, the 1x1 with no
  copy), a grouped and a depthwise case, with the launches by path;
  an ``amp.init("float16")`` Dense step whose forced overflow halves the
  loss scale and is reported by ``unscale``; the overflow check flagging
  an inf and a NaN and not a large finite float16 gradient, leaving the
  gradients as they are; quantize_mnist's int8 graph
  bound in an inference executor replaying with no host sync, equal to
  its eager forward and to the CPU's.
* the NumPy frontend: every small case of ``chip_smoke.np_cases()`` (one
  or more per name of ops/numpy_ops.py) and of ``NP_SCHEMA_CASES`` on the
  card against the CPU within its family's tolerance (``NP_TOL``, exact
  ops bit for bit), samplers repeating under one seed; one np-mode step
  of a 2-layer classifier at BERT-base width equal to the NDArray-mode
  step bit for bit, its output and loss ``mx.np.ndarray``.
* the run's lifecycle: a watchdog-bounded ``ShardedTrainer`` step (run in
  a waiter thread) called on a side stream under bfloat16 autocast equal
  to the inline step bit for bit, and ``wait_to_read`` behind about a
  second of device work raising ``StallError`` at a 0.05 s deadline.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from chip_smoke import _eager, _launches_per_call
from mxnet_tpu_torch import kernels, nd
from mxnet_tpu_torch.gluon.contrib import nn as cnn
from mxnet_tpu_torch.kernels import decode_attention, flash, int8_gemm, twobit
from mxnet_tpu_torch.kvstore import buckets, kvstore
from mxnet_tpu_torch.ops import registry as reg

F32_TOL, BF16_TOL = 2e-5, 2e-2


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import or collection."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_card.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(shape, seed, scale=0.5):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.gpu
def test_gradients_flow_through_the_flash_kernel_on_card(cuda_device):
    b, h, s, d = 2, 4, 100, 64
    q, k, v, do = (_rand((b, h, s, d), seed) for seed in range(4))
    arrays = [mx.nd.array(a) for a in (q, k, v)]
    for a in arrays:
        a.attach_grad()
    kernels.reset_launch_counts()
    with mx.autograd.record():
        out = nd.contrib.flash_attention(*arrays, causal=True)
    out.backward(mx.nd.array(do))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    want = flash.flash_backward_plain(
        *(a._data.detach() for a in arrays), out._data.detach(),
        torch.from_numpy(do).to(cuda_device), 1 / math.sqrt(d), True)
    for a, w in zip(arrays, want):
        assert a.grad is not None
        torch.testing.assert_close(a.grad._data, w, rtol=F32_TOL,
                                   atol=F32_TOL)

    mha = cnn.MultiHeadAttention(64, 4)
    mha.initialize(mx.init.Xavier(),
                   generator=torch.Generator().manual_seed(0))
    x = mx.nd.array(_rand((2, 16, 64), seed=5))
    mha(x)  # resolve deferred shapes
    weights = [getattr(mha, n).weight.data()._data.requires_grad_(True)
               for n in ("query", "key", "value")]
    fns = (flash.flash_forward, flash.flash_backward_dq,
           flash.flash_backward_dkv)
    copies = [f.copies for f in fns]
    kernels.reset_launch_counts()
    with mx.autograd.record():
        y = mha(x)
    grads = torch.autograd.grad(y._data.square().sum(), weights,
                                allow_unused=True)
    for g in grads:
        assert g is not None and torch.count_nonzero(g) > 0
    # the heads' transposed views are read in place both ways
    assert [f.copies for f in fns] == copies
    counts = kernels.launch_counts()
    assert counts["flash_attention_bwd_dq.mma"] == 1
    assert counts["flash_attention_bwd_dkv.mma"] == 1


def _bwd_operand(a, device, dtype, layout):
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
    ((4, 12, 128, 128, 64), torch.bfloat16, True, "dense"),
    ((2, 4, 100, 100, 64), torch.float32, True, "dense"),
    ((2, 4, 96, 80, 40), torch.float32, True, "dense"),
    ((2, 4, 128, 256, 64), torch.float32, False, "dense"),
    ((2, 4, 64, 64, 256), torch.float32, False, "dense"),
    ((2, 4, 48, 48, 512), torch.bfloat16, False, "dense"),
    ((2, 4, 100, 72, 64), torch.bfloat16, True, "dense"),
    ((4, 12, 128, 128, 64), torch.float32, False, "bshd"),
    ((2, 4, 100, 100, 128), torch.float32, True, "bshd"),
    ((2, 4, 96, 80, 40), torch.bfloat16, True, "bshd"),
    ((2, 4, 64, 64, 256), torch.float32, True, "bshd"),
    ((2, 4, 128, 128, 64), torch.float32, False, "unaligned"),
    ((2, 4, 100, 100, 128), torch.bfloat16, True, "unaligned"),
])
def test_backward_kernels_match_plain_on_card(cuda_device, shape, dtype,
                                              causal, layout):
    """Each launch on the path its head dim takes, q and dO read in place
    unless their rows are off 16 bytes (then each is copied once per
    kernel), the gradients in their inputs' memory order, two calls
    bit-equal (no atomics), and every gradient within the tolerance of the
    dense recompute."""
    b, h, sq, sk, d = shape
    q, do = (_bwd_operand(_rand((b, h, sq, d), s), cuda_device, dtype,
                          layout) for s in (1, 2))
    k, v = (_bwd_operand(_rand((b, h, sk, d), s), cuda_device, dtype,
                         "bshd" if layout == "bshd" else "dense")
            for s in (3, 4))
    scale = 1 / math.sqrt(d)
    fns = (flash.flash_backward_dq, flash.flash_backward_dkv)
    path = "mma" if d <= 128 else "simt"

    def backward():
        before = [(dict(f.launches_by_path), f.copies) for f in fns]
        o, lse = flash.flash_forward(q, k, v, scale, causal, with_lse=True)
        dq, dsum = flash.flash_backward_dq(q, k, v, o, lse, do, scale,
                                           causal)
        dk, dv = flash.flash_backward_dkv(q, k, v, lse, dsum, do, scale,
                                          causal)
        torch.cuda.synchronize()
        for f, (paths, copies) in zip(fns, before):
            assert f.launches_by_path[path] == paths[path] + 1
            assert sum(f.launches_by_path.values()) == sum(paths.values()) + 1
            assert f.copies == copies + 2 * (layout == "unaligned")
        return o, (dq, dk, dv)

    o, grads = backward()
    again = backward()[1]
    want = flash.flash_backward_plain(q, k, v, o, do, scale, causal)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for g, g2, w, t in zip(grads, again, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert torch.equal(g, g2)
        if layout == "bshd":
            assert g.permute(0, 2, 1, 3).is_contiguous()
        else:
            assert g.is_contiguous()
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


def _opt_state(shapes, family, device, seed=7):
    cols = 3 if family == "opt_sgd" else 4
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for j, scale in enumerate((0.05, 0.01, 1e-3, 1e-3)[:cols]):
        col = [torch.randn(s, generator=gen, device=device) * scale
               for s in shapes]
        out.append([t.square() for t in col] if j == 3 else col)
    return out


def _at_4_bytes(t):
    """``t`` copied into a buffer one float past its start: 4 bytes off
    the 16-byte alignment (``buf[1:1 + n]``)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


OPT_SHAPES = [(1,), (127,), (129,), (40, 33), (16385,), (30522, 7),
              (10 ** 7 + 3,)]
# which operand lies 4 bytes off (its tensors take the scalar path), or
# "lr groups": Optimizer.fused_update_multi with two learning rates
OPT_LAYOUTS = [("opt_sgd", lay) for lay in
               ("aligned", "w", "g", "m", "lr groups")] + \
    [("opt_adam", lay) for lay in
     ("aligned", "w", "g", "m", "v", "lr groups")]


def _opt_via_optimizer(family, cols, wd, hyper, route):
    """Three ``Optimizer.fused_update_multi`` updates of ``cols`` in
    place, lr_mult 0.5 on every other tensor: two learning-rate groups;
    through the kernel or (``route="plain"``) its plain version."""
    name = "sgd" if family == "opt_sgd" else "adam"
    kw = {"momentum": 0.9} if name == "sgd" else {}
    opt = mx.optimizer.create(name, learning_rate=1e-3, wd=wd,
                              rescale_grad=hyper["rescale_grad"],
                              clip_gradient=hyper["clip_gradient"], **kw)
    n = len(cols[0])
    opt.set_lr_mult({i: 0.5 for i in range(1, n, 2)})
    weights, grads = [nd.NDArray(t) for t in cols[0]], \
        [nd.NDArray(t) for t in cols[1]]
    states = [nd.NDArray(m) for m in cols[2]] if name == "sgd" else \
        [(nd.NDArray(m), nd.NDArray(v)) for m, v in zip(cols[2], cols[3])]
    e = kernels.entry(family)
    kernel = e.kernel
    if route == "plain":
        e.kernel = e.plain
    try:
        for _ in range(3):
            opt.fused_update_multi(list(range(n)), weights, grads, states)
    finally:
        e.kernel = kernel


@pytest.mark.gpu
@pytest.mark.parametrize("family,layout", OPT_LAYOUTS)
@pytest.mark.parametrize("rescale,clip,wd", [
    (1.0, -1.0, 0.0), (0.5, -1.0, 1e-4), (1.0, 0.004, 1e-2),
    (0.5, 0.004, 1e-4)])
def test_optimizer_kernels_are_bitwise_the_plain_versions(
        cuda_device, family, layout, rescale, clip, wd):
    """Every tensor on the path its alignment gives, one launch per call
    (per learning-rate group through the Optimizer), bit for bit; the
    skip flag leaves everything as it was."""
    base = _opt_state(OPT_SHAPES, family, cuda_device)
    got = [[t.clone() for t in col] for col in base]
    want = [[t.clone() for t in col] for col in base]
    lr = torch.tensor(1e-3, device=cuda_device)
    wds = [wd] * len(OPT_SHAPES)
    hyper = {"momentum": 0.9} if family == "opt_sgd" else {}
    hyper.update(rescale_grad=rescale, clip_gradient=clip)
    e = kernels.entry(family)
    before, paths = e.kernel.launches, dict(e.kernel.tensors_by_path)
    if layout == "lr groups":
        _opt_via_optimizer(family, got, wd, hyper, "kernel")
        _opt_via_optimizer(family, want, wd, hyper, "plain")
        launches = 6
    else:
        operand = "wgmv".find(layout)
        if operand >= 0:
            got[operand] = [_at_4_bytes(t) for t in got[operand]]
        e.kernel(*got, lr, wds, **hyper)
        e.plain(*want, lr, wds, **hyper)
        launches = 1
    torch.cuda.synchronize()
    assert e.kernel.launches == before + launches
    n = len(OPT_SHAPES) * (3 if layout == "lr groups" else 1)
    scalar = n if layout in ("w", "g", "m", "v") else 0
    assert {k: e.kernel.tensors_by_path[k] - paths[k] for k in paths} == \
        {"vec4": n - scalar, "scalar": scalar}
    for col_g, col_w in zip(got, want):
        for a, b in zip(col_g, col_w):
            assert torch.equal(a, b)
    assert not torch.equal(got[0][-1], base[0][-1])
    if layout != "lr groups":
        skipped = [list(col) for col in got]
        frozen = [[t.clone() for t in col] for col in got]
        e.kernel(*skipped, lr, wds, skip=torch.ones((), device=cuda_device),
                 **hyper)
        torch.cuda.synchronize()
        assert e.kernel.launches == before + 2
        for col_s, col_f in zip(skipped, frozen):
            assert all(torch.equal(a, b) for a, b in zip(col_s, col_f))


def _int8(shape, seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        -127, 128, shape).astype(np.int8))


def _at_byte_offset(t):
    """``t`` copied into a buffer one byte past its start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,unaligned", [
    (4096, 768, 768, None), (4096, 3072, 768, None), (32, 768, 2, None),
    (129, 130, 3, None), (17, 5, 129, None), (1, 1, 1, None),
    # the edges of the 128-row, 64/128-column, 64-byte-k tiles
    (127, 64, 129, None), (4095, 784, 768, None), (256, 3072, 3072, None),
    (128, 16, 128, None), (128, 48, 8, None),
    # an operand one byte into its buffer: the staged path
    (4096, 768, 768, "qx"), (127, 64, 129, "weight")])
@pytest.mark.parametrize("bias,relu,per_channel", [
    (True, False, True), (False, True, False), (True, True, True)])
def test_int8_gemm_kernel_is_bitwise_the_plain_version(
        cuda_device, m, k, n, unaligned, bias, relu, per_channel):
    qx, w = _int8((m, k), 1).to(cuda_device), _int8((n, k), 2).to(cuda_device)
    if unaligned == "qx":
        qx = _at_byte_offset(qx)
    elif unaligned == "weight":
        w = _at_byte_offset(w)
    scale = torch.from_numpy(_rand((n if per_channel else 1,), 3) ** 2
                             * 1e-3 + 1e-5).to(cuda_device)
    b = torch.from_numpy(_rand((n,), 4)).to(cuda_device) if bias else None
    path = "async" if k % 16 == 0 and unaligned is None else "staged"
    want = int8_gemm.int8_gemm_plain(qx, w, scale, bias=b, relu=relu)
    for tile_n in (0, 64, 128):
        before = int8_gemm.int8_gemm.launches
        before_path = int8_gemm.int8_gemm.launches_by_path[path]
        got = int8_gemm.int8_gemm(qx, w, scale, bias=b, relu=relu,
                                  tile_n=tile_n)
        torch.cuda.synchronize()
        assert int8_gemm.int8_gemm.launches == before + 1
        assert int8_gemm.int8_gemm.launches_by_path[path] == before_path + 1
        assert torch.equal(got, want), tile_n


@pytest.mark.gpu
def test_int8_gemm_main_shape_takes_the_async_path(cuda_device):
    """A (4096, 768, 768) product, as the served encoder's q, k, v and
    projection, launches on the cp.async tensor-core path."""
    qx, w = _int8((4096, 768), 5).to(cuda_device), \
        _int8((768, 768), 6).to(cuda_device)
    scale = torch.full((768,), 1e-4, device=cuda_device)
    kernels.reset_launch_counts()
    int8_gemm.int8_gemm(qx, w, scale)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["int8_gemm"] == 1
    assert counts["int8_gemm.async"] == 1 and counts["int8_gemm.staged"] == 0
    assert int8_gemm.tile_config(4096, 768)["blocks_per_sm"] >= 1


@pytest.mark.gpu
def test_quantized_fully_connected_on_card_equals_cpu(cuda_device):
    """3-D data through the op: the int8 product is exact on both sides,
    so the card's answer is the CPU's bit for bit."""
    x = _rand((4, 128, 768), 5, scale=2.0)
    w = _int8((3072, 768), 6)
    scale = torch.from_numpy(_rand((3072,), 7) ** 2 * 1e-3 + 1e-5)
    b = torch.from_numpy(_rand((3072,), 8))
    kw = dict(num_hidden=3072, flatten=False, min_calib_range=float(x.min()),
              max_calib_range=float(x.max()))
    fc = reg.get("_contrib_quantized_fully_connected")
    want = fc(torch.from_numpy(x), w, scale, b, **kw)
    before = kernels.launch_counts()["int8_gemm"]
    got = fc(*(t.to(cuda_device) for t in (torch.from_numpy(x), w, scale, b)),
             **kw)
    assert kernels.launch_counts()["int8_gemm"] == before + 1
    assert got.shape == (4, 128, 3072)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((32, 12, 1024, 64), torch.float32), ((32, 12, 1024, 64), torch.bfloat16),
    ((4, 12, 1000, 64), torch.float32), ((3, 5, 77, 8), torch.float32),
    ((2, 4, 300, 128), torch.bfloat16), ((2, 2, 129, 256), torch.float32),
    ((1, 1, 1, 64), torch.float32)])
def test_decode_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    """K5 through ``nd.contrib.decode_attention`` against the plain
    version, ragged lengths from 1 to S; cache rows past a length do not
    reach the output."""
    b, h, s, d = shape
    rs = np.random.RandomState(s + d)
    q, k, v = (torch.from_numpy(rs.randn(*sh).astype(np.float32))
               .to(cuda_device, dtype)
               for sh in ((b, h, d), (b, h, s, d), (b, h, s, d)))
    lengths = torch.from_numpy(rs.randint(1, s + 1, b).astype(np.int32))
    lengths[0], lengths[-1] = 1, s
    lengths = lengths.to(cuda_device)
    before = kernels.launch_counts()["decode_attention"]
    got = nd.contrib.decode_attention(*(mx.nd.NDArray(t)
                                        for t in (q, k, v, lengths)))._data
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] == before + 1
    want = decode_attention.decode_attention_plain(q, k, v, lengths,
                                                   1 / math.sqrt(d))
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if s > 1:
        k2, v2 = k.clone(), v.clone()
        k2[0, :, 1:], v2[0, :, 1:] = 1e4, -1e4   # row 0 has length 1
        moved = decode_attention.decode_attention(q, k2, v2,
                                                  lengths, 1 / math.sqrt(d))
        assert torch.equal(moved[0], got[0])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 4097, 1 << 20])
@pytest.mark.parametrize("offset", [0, 1])
def test_twobit_kernels_are_bitwise_the_plain_versions(cuda_device, n,
                                                       offset):
    """K6 and K7 with torch.equal against their plain versions, aligned
    (16-byte accesses) and offset by one element (one at a time), on
    int8 codes, their int8 sum in [-2, 2] and an int32 sum."""
    rs = np.random.RandomState(n + offset)
    g, r = (torch.from_numpy((rs.randn(n + offset) * sc).astype(np.float32))
            .to(cuda_device)[offset:] for sc in (0.4, 0.2))
    g[0], r[0] = 0.5, 0.0   # exactly at the threshold
    before = kernels.launch_counts()
    codes, res = twobit.twobit_compress(g, r, 0.5)
    want_codes, want_res = twobit.twobit_compress_plain(g, r, 0.5)
    summed = (codes.to(torch.int32) + want_codes.flip(0).to(torch.int32))
    outs = [(twobit.twobit_decompress(c, 0.5), twobit.twobit_decompress_plain(
        c, 0.5)) for c in (codes, summed.to(torch.int8), summed * 3)]
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["twobit_compress"] == before["twobit_compress"] + 1
    assert after["twobit_decompress"] == before["twobit_decompress"] + 3
    assert codes.dtype == torch.int8 and int(codes[0]) == 1
    assert torch.equal(codes, want_codes) and torch.equal(res, want_res)
    for got, want in outs:
        assert torch.equal(got, want)


BERT_LAYER = [(768,), (768,), (768, 768), (768,), (768, 768), (768,),
              (768, 768), (768,), (768, 768), (768,), (3072, 768), (3072,),
              (768, 3072), (768,), (2, 768), (2,)]
ODD = [(1,), (2,), (3,), (127,), (4097,), (33, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("shapes,offset,keys", [
    (ODD, 0, None), (ODD, 1, None), (BERT_LAYER, 3, None),
    (BERT_LAYER, 0, None), (BERT_LAYER, 0, [1, 3, 10, 14]),
    ([(4096 * 300 + 17,), (5,)], 0, [0])],
    ids=["odd", "odd+1", "bert_layer+3", "bert_layer", "subset",
         "ragged_subset"])
@pytest.mark.parametrize("thr", [0.5, 0.05])
def test_twobit_multi_kernels_are_bitwise_the_plain_versions(
        cuda_device, shapes, offset, keys, thr):
    """The multi-tensor compress over the listed keys of the kvstore's
    flat layout (4 MiB buckets) against its plain version on copies of
    the same buffers: the whole wire and residual buffers equal, so no
    byte outside the listed slots moved; gradients ``offset`` floats off
    16-byte alignment take the scalar path. Then the decompress of the
    wire and of summed codes, aligned (vec16) and one code in (scalar). Values at +-thr and a NaN lead every gradient."""
    plan = buckets.BucketPlan(4 << 20)
    for i, sh in enumerate(shapes):
        plan.register(i, sh, "float32")
    lay = buckets.FlatLayout(plan, cuda_device)
    keys = list(range(len(shapes))) if keys is None else keys
    rs = np.random.RandomState(len(shapes) + offset)
    lay.residual.copy_(torch.from_numpy(
        (rs.randn(lay.residual.numel()) * thr).astype(np.float32)))
    grads = []
    for k in keys:
        n = math.prod(shapes[k])
        g = torch.from_numpy((rs.randn(n + offset) * thr * 2).astype(
            np.float32)).to(cuda_device)[offset:].view(shapes[k])
        edge = torch.tensor([thr, -thr, float("nan")])[:min(n, 3)]
        g.view(-1)[:edge.numel()] = edge.to(cuda_device)
        lay.residuals[k].view(-1)[:edge.numel()] = 0.0
        grads.append(g)
    wire, res = lay.wire.clone(), lay.residual.clone()
    views = [(res[lay.offsets[k]:lay.offsets[k] + lay.codes[k].numel()],
              wire[lay.offsets[k]:lay.offsets[k] + lay.codes[k].numel()])
             for k in keys]
    fn = twobit.twobit_compress_multi
    before, paths = fn.launches, dict(fn.tensors_by_path)
    kernels.dispatch("twobit_compress_multi", grads,
                     [lay.residuals[k] for k in keys],
                     [lay.codes[k] for k in keys], thr)
    twobit.twobit_compress_multi_plain(grads, *zip(*views), thr)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    vec = len(keys) if offset == 0 else 0
    assert {p: fn.tensors_by_path[p] - paths[p] for p in paths} == \
        {"vec16": vec, "scalar": len(keys) - vec}
    assert torch.equal(lay.wire, wire)
    nan = torch.isnan(lay.residual)
    assert torch.equal(nan, torch.isnan(res)) and nan.sum() == len(
        [k for k in keys if math.prod(shapes[k]) >= 3])
    assert torch.equal(lay.residual.masked_fill(nan, 0), res.masked_fill(
        nan, 0))
    assert (lay.wire != 0).any()
    dec = twobit.twobit_decompress
    summed = (lay.wire.to(torch.int32) * 2).clamp(-2, 2).to(torch.int8)
    for codes in (lay.wire, summed):
        for lo, path in ((0, "vec16"), (1, "scalar")):
            n0 = dec.launches_by_path[path]
            got = kernels.dispatch("twobit_decompress", codes[lo:], thr)
            assert dec.launches_by_path[path] == n0 + 1
            assert torch.equal(got, twobit.twobit_decompress_plain(
                codes[lo:], thr))


@pytest.mark.gpu
def test_twobit_multi_compress_caches_its_table_on_card(cuda_device):
    """A second call over the same tensors reuses the table; a new
    gradient address builds another."""
    plan = buckets.BucketPlan(4 << 20)
    for i, sh in enumerate(BERT_LAYER):
        plan.register(i, sh, "float32")
    lay = buckets.FlatLayout(plan, cuda_device)
    grads = [torch.randn(sh, device=cuda_device) for sh in BERT_LAYER]
    args = ([lay.residuals[k] for k in range(len(grads))],
            [lay.codes[k] for k in range(len(grads))], 0.5)
    builds = twobit._TABLES.builds
    twobit.twobit_compress_multi(grads, *args)
    twobit.twobit_compress_multi(grads, *args)
    assert twobit._TABLES.builds == builds + 1
    grads[3] = grads[3].clone()
    twobit.twobit_compress_multi(grads, *args)
    torch.cuda.synchronize()
    assert twobit._TABLES.builds == builds + 2


# ---- 2-bit compression in float16 and bfloat16 (fault C4) ----------------

HALF = [torch.float16, torch.bfloat16]


def _same(a, b):
    """Bit for bit, NaN equal to NaN at the same positions."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.masked_fill(nan, 0), b.masked_fill(nan, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", HALF, ids=["float16", "bfloat16"])
@pytest.mark.parametrize("n", [1, 7, 9, 4097, 1 << 20])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("thr", [0.5, 0.1, 0.3])
def test_twobit_half_kernels_are_bitwise_the_plain_versions(
        cuda_device, dtype, n, offset, thr):
    """K6 on a half-precision gradient and K7 writing half precision,
    torch.equal against the plain versions, 16-byte aligned (8 halves an
    access) and one element off (one at a time); gradients at the
    threshold rounded to the dtype, at the unrounded one, and NaN; codes,
    their int8 sum and an int32 sum."""
    rs = np.random.RandomState(n + offset)
    g, r = (torch.from_numpy((rs.randn(n + offset) * sc).astype(np.float32))
            .to(cuda_device, dtype)[offset:] for sc in (thr, thr * 0.4))
    t = twobit.round_threshold(thr, dtype)
    edge = torch.tensor([t, -t, thr, -thr, float("nan")])[:n]
    g[:edge.numel()] = edge.to(cuda_device, dtype)
    r[:edge.numel()] = 0
    before = twobit.twobit_compress.launches
    codes, res = twobit.twobit_compress(g, r, thr)
    want_codes, want_res = twobit.twobit_compress_plain(g, r, thr)
    torch.cuda.synchronize()
    assert twobit.twobit_compress.launches == before + 1
    assert res.dtype == dtype and int(codes[0]) == 1
    assert torch.equal(codes, want_codes) and _same(res, want_res)
    summed = codes.to(torch.int32) + want_codes.flip(0).to(torch.int32)
    for c in (codes, summed.to(torch.int8), summed * 3):
        got = twobit.twobit_decompress(c[offset:], thr, dtype)
        assert got.dtype == dtype
        assert torch.equal(got, twobit.twobit_decompress_plain(
            c[offset:], thr, dtype))


C4_THR = 0.5
# the JAX package's dist_sync store (one worker's codes as the sum): the
# pulled values over the threshold in the three rounds of c4_grads(), the
# same in float16 and bfloat16, and the residual after the third round
C4_CODES = [
    [[0, 0, -1, 0], [0, -1, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0]],
    [[0, 1, 0, 0], [-1, 0, 0, 0], [1, 0, 1, -1], [1, -1, -1, 1]],
    [[0, -1, 0, 1], [1, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 1]],
]
C4_RESIDUAL = {
    "float16": [[-0.304931640625, -0.1865234375, -0.3271484375,
                 0.44677734375],
                [0.412109375, 0.130859375, -0.45849609375, 0.111572265625],
                [0.34716796875, 0.35400390625, 0.078125, -0.225830078125],
                [0.15771484375, 0.364013671875, -0.26611328125,
                 0.25732421875]],
    "bfloat16": [[-0.302734375, -0.1796875, -0.328125, 0.4453125],
                 [0.40625, 0.134765625, -0.458984375, 0.111328125],
                 [0.34375, 0.35546875, 0.08203125, -0.224609375],
                 [0.15625, 0.36328125, -0.267578125, 0.26171875]],
}


def c4_grads():
    rs = np.random.RandomState(4)
    return [(rs.randn(4, 4) * 0.6).astype(np.float32) for _ in range(3)]


def c4_port_run(ctx, dtype):
    """Fault C4's reproduction on ``ctx``: a ``(4, 4)`` key of ``dtype``
    in a ``dist_sync`` store with 2-bit compression (threshold 0.5), three
    push/pull rounds of ``c4_grads()``. One process stands for two
    workers (``_procs = 2``, each collective the identity), so the key
    takes the compressed path. Returns each round's pulled values over
    the threshold and the final residual, as float64 arrays."""
    kv = mx.kv.create("dist_sync")
    kv.set_gradient_compression({"type": "2bit", "threshold": C4_THR})
    kv._procs = 2
    kv._dispatch_bucket = lambda flat: kvstore._Reduction(flat, None)
    kv._cross_host_sum = lambda v: mx.nd.NDArray(v._data.clone())
    kv.init(0, mx.nd.zeros((4, 4), dtype=dtype, ctx=ctx))
    rounds = []
    for g in c4_grads():
        kv.push(0, mx.nd.array(g, dtype=dtype, ctx=ctx))
        out = mx.nd.zeros((4, 4), dtype=dtype, ctx=ctx)
        kv.pull(0, out=out)
        assert out.dtype == getattr(torch, dtype)
        rounds.append(out.asnumpy().astype(np.float64) / C4_THR)
    res = kv._residuals[0]
    assert res.dtype == getattr(torch, dtype) and res.device == \
        ctx.torch_device()
    return rounds, res.float().cpu().numpy().astype(np.float64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_c4_a_half_precision_key_under_2bit_compression_on_card(
        cuda_device, dtype):
    """Raised before the half-precision kernels; now the card's pulled
    values and residual equal the CPU run and the JAX store's bit for
    bit, and both kernels launched on the card."""
    before = kernels.launch_counts()
    rounds, res = c4_port_run(mx.gpu(), dtype)
    after = kernels.launch_counts()
    assert after["twobit_compress"] - before["twobit_compress"] == 3
    assert after["twobit_decompress"] - before["twobit_decompress"] == 3
    cpu_rounds, cpu_res = c4_port_run(mx.cpu(), dtype)
    for got, cpu, want in zip(rounds, cpu_rounds, C4_CODES):
        assert np.array_equal(got, cpu) and np.array_equal(got, want)
    assert np.array_equal(res, cpu_res)
    assert np.array_equal(res, np.asarray(C4_RESIDUAL[dtype]))


# ---- convolution, pooling and BatchNorm: card against CPU ---------------

# float32 with TF32 off; cuDNN and the CPU sum in other orders: forward
# 1e-5 and gradients 1e-4 of the reference's largest magnitude
NN_FWD_TOL, NN_GRAD_TOL = 1e-5, 1e-4
NN_CASES = [
    ("Convolution", [(8, 64, 28, 28), (128, 64, 3, 3)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=128,
          no_bias=True)),
    ("Convolution", [(8, 64, 14, 14), (256, 64, 1, 1), (256,)],
     dict(kernel=(1, 1), num_filter=256)),
    ("Convolution", [(4, 3, 56, 56), (64, 3, 7, 7)],
     dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3), num_filter=64,
          no_bias=True)),
    ("Convolution", [(2, 8, 15, 13), (12, 4, 3, 2), (12,)],
     dict(kernel=(3, 2), dilate=(2, 1), pad=(2, 0), num_filter=12,
          num_group=2)),
    ("Convolution", [(2, 4, 33), (6, 4, 3), (6,)],
     dict(kernel=(3,), stride=(2,), pad=(1,), num_filter=6)),
    ("Convolution", [(1, 3, 6, 7, 8), (4, 3, 3, 3, 3)],
     dict(kernel=(3, 3, 3), pad=(1, 1, 1), num_filter=4, no_bias=True)),
    ("Pooling", [(8, 64, 56, 56)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
          relu=True)),
    ("Pooling", [(4, 16, 11, 10)],
     dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          pooling_convention="full", count_include_pad=False)),
    ("Pooling", [(4, 16, 11, 10)],
     dict(kernel=(2, 2), stride=(2, 2), pool_type="max",
          pooling_convention="same")),
    ("Pooling", [(8, 256, 7, 7)], dict(pool_type="avg", global_pool=True)),
    ("_contrib_AdaptiveAvgPooling2D", [(4, 8, 13, 11)],
     dict(output_size=(3, 4))),
    ("BatchNorm", "bn", dict(eps=1e-5, fix_gamma=False, training=True)),
    ("BatchNorm", "bn", dict(eps=1e-3, fix_gamma=True, training=True)),
    ("BatchNorm", "bn", dict(eps=1e-5, fix_gamma=False, training=False)),
]


def _nn_inputs(op, shapes, rs):
    if shapes == "bn":
        x = rs.randn(8, 64, 14, 14).astype(np.float32) * 2 + 1
        c = x.shape[1]
        return [x, rs.rand(c).astype(np.float32) + 0.5,
                rs.randn(c).astype(np.float32),
                rs.randn(c).astype(np.float32),
                rs.rand(c).astype(np.float32) + 0.5], [0, 1, 2]
    arrays = [rs.randn(*s).astype(np.float32) * (0.2 if i else 1.0)
              for i, s in enumerate(shapes)]
    return arrays, list(range(len(arrays)))


def _nn_run(op, arrays, diff, kw, device, dy):
    ts = [torch.tensor(a, device=device, requires_grad=i in diff)
          for i, a in enumerate(arrays)]
    out = reg.get(op)(*ts, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    (outs[0] * torch.from_numpy(dy).to(device)).sum().backward()
    # with fix_gamma, gamma takes no part: no gradient (the JAX op's is 0)
    return ([o.detach().cpu().numpy() for o in outs],
            [np.zeros(ts[i].shape, np.float32) if ts[i].grad is None
             else ts[i].grad.cpu().numpy() for i in diff])


@pytest.mark.gpu
@pytest.mark.parametrize("op,shapes,kw", NN_CASES)
def test_conv_pool_batchnorm_on_card_equal_cpu(cuda_device, op, shapes, kw):
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(kw)
    rs = np.random.RandomState(7)
    arrays, diff = _nn_inputs(op, shapes, rs)
    if kw.pop("relu", False):
        arrays[0] = np.maximum(arrays[0], 0)
    ref = reg.get(op)(*[torch.from_numpy(a) for a in arrays], **kw)
    ref = ref[0] if isinstance(ref, tuple) else ref
    dy = rs.randn(*ref.shape).astype(np.float32)
    got = _nn_run(op, arrays, diff, kw, cuda_device, dy)
    want = _nn_run(op, arrays, diff, kw, torch.device("cpu"), dy)
    for tol, gs, ws in ((NN_FWD_TOL, got[0], want[0]),
                        (NN_GRAD_TOL, got[1], want[1])):
        for g, w in zip(gs, ws):
            scale = max(float(np.abs(w).max()), 1.0)
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale)


# ---- bfloat16 training: ops, the three routes, checkpoints ---------------
# one bfloat16 ulp of the largest output (2**-7 of it) and two for the
# products, whose float32 sums cuDNN and the CPU take in other orders
BF16_ULP = 2.0 ** -7
BF16_CASES = [
    ("Convolution", dict(kernel=(3, 3), pad=(1, 1), num_filter=16), 2),
    ("Pooling", dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="max"), 0),
    ("Pooling", dict(kernel=(1, 1), global_pool=True, pool_type="avg"), 1),
    ("FullyConnected", dict(num_hidden=5), 2),
    ("BatchNorm", dict(eps=1e-5, fix_gamma=False, training=True), 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("op,kw,ulps", BF16_CASES)
def test_bfloat16_ops_on_card_equal_cpu(cuda_device, op, kw, ulps):
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rs = np.random.RandomState(11)
    x = rs.randn(4, 8, 10, 10).astype(np.float32)
    extra = {"Convolution": [rs.randn(16, 8, 3, 3) * 0.2, rs.randn(16)],
             "FullyConnected": [rs.randn(5, 800) * 0.05, rs.randn(5)],
             "BatchNorm": [rs.rand(8) + 0.5, rs.randn(8), np.zeros(8),
                           np.ones(8)]}.get(op, [])
    outs = []
    for device in (cuda_device, torch.device("cpu")):
        args = [torch.tensor(x, device=device).to(torch.bfloat16)]
        for a in extra:
            t = torch.tensor(np.asarray(a, np.float32), device=device)
            args.append(t if op == "BatchNorm" else t.to(torch.bfloat16))
        out = reg.get(op)(*args, **kw)
        outs.append(out[0] if isinstance(out, tuple) else out)
    got, want = (o.float().cpu().numpy() for o in outs)
    assert outs[0].dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ulps * BF16_ULP * np.abs(want).max())


def _bf16_trainer(device, mp, scheduler=None):
    from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

    ctx = mx.gpu(0) if device.type == "cuda" else mx.cpu()
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(8, 3, padding=1, in_channels=3,
                                   use_bias=False),
                mx.gluon.nn.BatchNorm(in_channels=8),
                mx.gluon.nn.Activation("relu"),
                mx.gluon.nn.GlobalAvgPool2D(),
                mx.gluon.nn.Dense(4, in_units=8))
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=torch.Generator().manual_seed(0))
    net.cast("bfloat16")
    params = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
              "multi_precision": mp}
    if scheduler is not None:
        params["lr_scheduler"] = scheduler
    return ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                          "sgd", params,
                          mesh=DeviceMesh({"dp": 1}, devices=[ctx]))


def _bf16_batch(device, seed=0):
    rs = np.random.RandomState(seed)
    x = torch.tensor(rs.rand(8, 3, 12, 12).astype(np.float32),
                     device=device).to(torch.bfloat16)
    return mx.nd.NDArray(x), mx.nd.NDArray(torch.tensor(
        rs.randint(0, 4, 8).astype(np.float32), device=device))


@pytest.mark.gpu
@pytest.mark.parametrize("mp", [True, False])
def test_bfloat16_sharded_steps_take_their_routes_on_card(cuda_device, mp):
    """K1 launches once a step over the float32 tensors (the masters
    among them with ``multi_precision``), each on its 16-byte path; the
    bfloat16 weights take the plain route otherwise; every weight stays
    its master rounded."""
    x, y = _bf16_batch(cuda_device)
    st = _bf16_trainer(cuda_device, mp)
    st.step(x, y)   # the first step builds K1's table
    sgd = kernels.entry("opt_sgd").kernel
    launches, paths = sgd.launches, dict(sgd.tensors_by_path)
    for _ in range(3):
        loss = st.step(x, y)
    torch.cuda.synchronize()
    census = st._routes.census()
    assert census == {"float32": 2, "master": 3 * mp, "half": 3 * (not mp)}
    assert sgd.launches - launches == 3
    assert sgd.tensors_by_path["vec4"] - paths["vec4"] == \
        3 * (census["float32"] + census["master"])
    assert sgd.tensors_by_path["scalar"] == paths["scalar"]
    assert bool(torch.isfinite(loss._data))
    for i in st._routes.master:
        assert torch.equal(st._train_handles[i]._data,
                           st._opt_state[i][0].to(torch.bfloat16))
    for g in st._grads32:
        assert g.data_ptr() % 16 == 0


@pytest.mark.gpu
def test_bfloat16_checkpoint_round_trips_and_resumes_on_card(cuda_device,
                                                             tmp_path):
    """``save_states`` of a card trainer loads into a fresh one bit for
    bit, with the Philox state (16 bytes) under ``__rng_key__``; with
    deterministic cuDNN the next step of both is the same."""
    from mxnet_tpu_torch import lr_scheduler

    torch.backends.cudnn.deterministic = True
    try:
        x, y = _bf16_batch(cuda_device, 1)
        st = _bf16_trainer(cuda_device, True,
                           lr_scheduler.MultiFactorScheduler([2], 0.1))
        for _ in range(3):
            st.step(x, y)
        fname = str(tmp_path / "card.states")
        st.save_states(fname)
        assert st._state_payload()["__rng_key__"].size == 16
        fresh = _bf16_trainer(cuda_device, True,
                              lr_scheduler.MultiFactorScheduler([2], 0.1))
        fresh.load_states(fname)
        for a, b in zip(st._state_tensors().values(),
                        fresh._state_tensors().values()):
            assert a.device == b.device and torch.equal(a, b)
        assert fresh._t == 3 and fresh.learning_rate == st.learning_rate
        la, lb = st.step(x, y), fresh.step(x, y)
        assert torch.equal(la._data, lb._data)
        for a, b in zip(st._state_tensors().values(),
                        fresh._state_tensors().values()):
            assert torch.equal(a, b)
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.gpu
def test_the_guard_flags_nan_and_inf_in_bfloat16_gradients_on_card(
        cuda_device):
    """PyTorch's fused finite check takes no bfloat16 on the card; the
    half-precision gradients go through a multi-tensor max-norm, which
    must carry a NaN or an infinity in any one element to the flag; and a
    bfloat16 step on a NaN batch is skipped with nothing changed."""
    st = _bf16_trainer(cuda_device, True)
    loss = torch.tensor(1.0, device=cuda_device, dtype=torch.bfloat16)
    grads = [torch.ones(33, 7, device=cuda_device, dtype=torch.bfloat16),
             torch.ones(5, device=cuda_device)]
    assert float(st._non_finite(loss, grads)) == 0
    for bad in (float("nan"), float("inf"), -float("inf")):
        g = [t.clone() for t in grads]
        g[0][17, 3] = bad
        assert float(st._non_finite(loss, g)) != 0, bad
        g = [t.clone() for t in grads]
        g[1][2] = bad
        assert float(st._non_finite(loss, g)) != 0, bad
    x, y = _bf16_batch(cuda_device)
    st.step(x, y)
    before = [t.clone() for t in st._state_tensors().values()]
    bad = x._data.clone()
    bad[1, 0, 2, 2] = float("nan")
    st.step(mx.nd.NDArray(bad), y)
    assert st.skipped_steps == 1
    assert all(torch.equal(a, b) for a, b in
               zip(before, st._state_tensors().values()))


# ------------------------------------------------------ captured forwards
# hybridize() and the served buckets as CUDA graphs (compile.py): every
# replay against the same forward run eagerly (compile.set_enabled(False))
# on the same inputs, bit for bit, and the launches each replay adds.

CAPTURE_CFG = {"vocab": 128, "units": 64, "hidden": 128, "heads": 4,
               "layers": 2, "seq_len": 16, "num_classes": 2}
CAPTURE_FC = 6 * CAPTURE_CFG["layers"] + 2  # int8 GEMMs a forward


def _capture_clf(exportable=False):
    from chip_smoke import build_classifier, random_params
    from mxnet_tpu_torch.convert import load_jax_params

    clf = build_classifier(mx, CAPTURE_CFG, exportable=exportable)
    clf.initialize(mx.init.Zero())
    load_jax_params(clf, random_params(CAPTURE_CFG, seed=0))
    return clf


def _capture_tokens(n, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, CAPTURE_CFG["vocab"],
                      (n, CAPTURE_CFG["seq_len"])).astype(np.float32)


@pytest.mark.gpu
def test_a_hybridized_block_replays_its_eager_forward_on_card(cuda_device):
    from mxnet_tpu_torch import compile as mxc

    clf = _capture_clf()
    clf.hybridize()
    before = mxc.stats().get("cachedop", {"captures": 0})["captures"]
    for n in (2, 5):
        x = mx.nd.array(_capture_tokens(n, seed=n))
        first = clf(x)._data     # the eager first call, then a capture
        again = clf(x)._data     # replays
        want = _eager(clf, x)._data
        assert torch.equal(first, want) and torch.equal(again, want)
        assert first.data_ptr() != again.data_ptr()
    assert mxc.stats()["cachedop"]["captures"] - before == 2
    replay = _launches_per_call(lambda: clf(x))
    eager = _launches_per_call(lambda: _eager(clf, x))
    assert replay == eager == {"flash_attention": 2,
                               "flash_attention.mma": 2}


@pytest.mark.gpu
def test_a_rebind_captures_anew_and_in_place_writes_replay_on_card(
        cuda_device):
    from mxnet_tpu_torch import compile as mxc

    clf = _capture_clf()
    clf.hybridize()
    x = mx.nd.array(_capture_tokens(3, seed=1))
    y0 = clf(x)._data.clone()
    st0 = dict(mxc.stats()["cachedop"])
    w = clf.out.weight
    w.set_data(w.data().asnumpy() * 2.0)            # a new tensor
    y1 = clf(x)._data
    st1 = dict(mxc.stats()["cachedop"])
    assert st1["captures"] - st0["captures"] == 1
    assert not torch.equal(y0, y1) and torch.equal(y1, _eager(clf, x)._data)
    with torch.no_grad():
        clf.pool.weight.data()._data.mul_(0.5)      # the same tensor
    y2 = clf(x)._data
    st2 = dict(mxc.stats()["cachedop"])
    assert st2["captures"] == st1["captures"]
    assert st2["hits"] - st1["hits"] == 1
    assert not torch.equal(y1, y2) and torch.equal(y2, _eager(clf, x)._data)


@pytest.mark.gpu
def test_train_then_evaluate_keeps_one_graph_on_card(cuda_device):
    """Each training step writes BatchNorm's running statistics in place,
    so the evaluation after it keeps its graph and replays with the new
    statistics (equal to the eager forward); the training calls run as
    the op's pair (eager at the first, captured at the second): the op
    keeps one inference entry and one pair, no round captures anew
    after the second, and the memory the allocator holds stays within
    one graph of where the third round started."""
    from mxnet_tpu_torch import compile as mxc
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.get_model("resnet18_v1", classes=10, thumbnail=True)
    net.initialize(mx.init.Xavier())
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.rand(16, 3, 32, 32).astype(np.float32))
    batches = [mx.nd.array(rs.rand(16, 3, 32, 32).astype(np.float32))
               for _ in range(5)]
    net(x)                       # resolves the deferred shapes
    net.hybridize()
    torch.cuda.synchronize()
    # release the cached blocks earlier tests left, so the first
    # capture's pool shows in memory_reserved
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    net(x)                       # the first capture
    torch.cuda.synchronize()
    graph_bytes = torch.cuda.memory_reserved() - reserved0
    assert graph_bytes > 0
    op, captures0 = net._cached_op, mxc.stats()["cachedop"]["captures"]
    stats = [p.data()._data for p in net.collect_params().values()
             if p.grad_req == "null"]
    ptrs = [t.data_ptr() for t in stats]
    reserved, allocated, outs, captures = [], [], [], []
    for batch in batches:
        with mx.autograd.record():
            loss = net(batch).sum()
        loss.backward()
        y = net(x)._data
        assert torch.equal(y, _eager(net, x)._data)
        outs.append(y)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
        allocated.append(torch.cuda.memory_allocated())
        captures.append(mxc.stats()["cachedop"]["captures"] - captures0)
    assert net._cached_op is op and len(op.stats()["entries"]) == 2
    assert [t.data_ptr() for t in stats] == ptrs
    assert captures == [0, 1, 1, 1, 1]
    assert max(reserved[2:]) - reserved[2] < graph_bytes, (reserved,
                                                           graph_bytes)
    assert max(allocated[2:]) - allocated[2] < graph_bytes, (allocated,
                                                             graph_bytes)
    assert not torch.equal(outs[0], outs[-1])


def _served_pair(tmp_path):
    """The exportable classifier served from its block, and its exported
    graph quantized to int8 on the card (naive calibration), served from
    the symbol."""
    from chip_smoke import make_task
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.contrib import quantization

    clf = _capture_clf(exportable=True)
    clf.export(str(tmp_path / "float"))
    sym, args, auxs = mx.model.load_checkpoint(str(tmp_path / "float"), 0)
    calib, _ = make_task(64, CAPTURE_CFG["seq_len"], CAPTURE_CFG["vocab"],
                         2, seed=1)
    qsym, qargs, qauxs = quantization.quantize_model(
        sym, args, auxs, data_names=("data",), calib_mode="naive",
        calib_data=mx.io.NDArrayIter(calib, batch_size=32, label_name=None),
        num_calib_examples=64)
    shape = (CAPTURE_CFG["seq_len"],)
    return (serving.ServedModel.from_block("f32", clf, example_shape=shape),
            serving.ServedModel.from_symbol("sym", sym, args, auxs,
                                            example_shape=shape),
            serving.ServedModel.from_symbol("int8", qsym, qargs, qauxs,
                                            example_shape=shape))


@pytest.mark.gpu
def test_served_buckets_replay_their_eager_forward_on_card(cuda_device,
                                                           tmp_path):
    """The block path, the symbol path and the int8 graph: every bucket
    captured by warmup, each replay equal to the eager forward, and the
    launches each replay adds (flash per layer; int8 GEMMs per quantized
    FullyConnected)."""
    from mxnet_tpu_torch import compile as mxc

    f32, sym, int8 = _served_pair(tmp_path)
    assert int8.quantized
    for model in (f32, sym, int8):
        model.warmup()
        st = model.capture_stats()
        assert st["captures"] == len(model.buckets)
        assert sorted(st["capture_ms_by_bucket"]) == list(model.buckets)
        misses = mxc.stats()["serving"]["misses"]
        for rows in (1, 3, 7, 16, 30):
            bucket = model.bucket_for(rows)
            x = np.zeros((bucket, CAPTURE_CFG["seq_len"]), np.float32)
            x[:rows] = _capture_tokens(rows, seed=rows)
            got = model.run(x, rows)[0]
            want = _eager(model.run, x, rows)[0]
            np.testing.assert_array_equal(got, want, err_msg=model.name)
        assert mxc.stats()["serving"]["misses"] == misses
    x = int8.host_batch(32)
    want = {"flash_attention": 2, "flash_attention.mma": 2,
            "int8_gemm": CAPTURE_FC, "int8_gemm.async": CAPTURE_FC}
    assert _launches_per_call(lambda: int8.run(x)) == want
    assert _launches_per_call(lambda: _eager(int8.run, x)) == want


@pytest.mark.gpu
def test_two_models_capture_and_serve_at_once_on_card(cuda_device, tmp_path):
    """One model's runner captures its ladder (warmup) while the other
    model, not warmed up, takes traffic and captures its buckets under
    it; every answer equals its model's eager forward."""
    import threading

    from mxnet_tpu_torch import serving

    f32, _, int8 = _served_pair(tmp_path)
    server = serving.ModelServer(serving.ModelContainer([f32, int8]),
                                 max_wait_ms=1.0).start()
    payloads = [_capture_tokens(k, seed=60 + k) for k in (1, 2, 3, 5, 9, 17)]
    answers, errors = {}, []

    def traffic():
        try:
            for i, x in enumerate(payloads):
                answers[i] = server.predict("int8", x, timeout=120)
        except Exception as e:  # reported below
            errors.append(e)

    try:
        t = threading.Thread(target=traffic)
        t.start()
        server._batcher("f32").warmup()
        t.join(timeout=300)
        assert not t.is_alive() and not errors, errors
        again = [server.predict("int8", x, timeout=120) for x in payloads]
        for i, x in enumerate(payloads):
            bucket = int8.bucket_for(x.shape[0])
            padded = np.zeros((bucket, x.shape[1]), np.float32)
            padded[:x.shape[0]] = x
            want = _eager(int8.run, padded, x.shape[0])[0]
            np.testing.assert_array_equal(answers[i], want)
            np.testing.assert_array_equal(again[i], want)
        assert int8.capture_stats()["captures"] == 5   # first met live
        assert f32.capture_stats()["captures"] == len(f32.buckets)
        info = server.model_info()
        assert info["int8"]["captures"] == 5 and info["int8"]["capture_ms"] > 0
    finally:
        assert server.drain(timeout=60)


@pytest.mark.gpu
def test_a_failed_capture_raises_naming_the_op_on_card(cuda_device):
    """A forward that waits for the card inside the captured region
    (``.item()``) fails the capture with ``CaptureError`` naming the op;
    no eager result comes back, and the process goes on using the card.
    Run in a child process, so the failed capture cannot touch the other
    tests' state."""
    import subprocess
    import sys

    script = "\n".join([
        "import torch",
        "import mxnet_tpu_torch as mx",
        "from mxnet_tpu_torch import compile as mxc",
        "from mxnet_tpu_torch.gluon import nn",
        "from mxnet_tpu_torch.ops.registry import register",
        "@register('_test_host_sync')",
        "def _host_sync(x):",
        "    return x * float(x.sum().item())",
        "class Net(nn.HybridBlock):",
        "    def hybrid_forward(self, F, x):",
        "        return F.invoke('_test_host_sync', x)",
        "net = Net()",
        "net.hybridize()",
        "x = mx.nd.array([[1.0, 2.0]])",
        "try:",
        "    net(x)",
        "    print('NO ERROR')",
        "except mxc.CaptureError as e:",
        "    print('CAPTURE ERROR', e)",
        "y = mx.nd.array([[3.0]])._data * 2",
        "torch.cuda.synchronize()",
        "print('CARD OK', float(y.sum()))"])
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300,
                         cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[1]))
    assert "CAPTURE ERROR" in out.stdout, out.stdout + out.stderr
    assert "op '_test_host_sync'" in out.stdout, out.stdout
    assert "NO ERROR" not in out.stdout
    assert "CARD OK 6.0" in out.stdout, out.stdout + out.stderr


@pytest.mark.gpu
def test_module_fit_trains_a_thumbnail_on_card(cuda_device):
    """``Module.fit`` (the symbolic path of ``train_imagenet.py``) on the
    thumbnail resnet18_v1 symbol for two batches on the card: a finite
    loss each batch, one K1 launch a batch (the local kvstore's
    ``update_multi``) and running statistics that moved off their
    initial zeros and ones."""
    from chip_smoke import (MODULE_CHECK, SyntheticDataIter,
                            _softmax_loss, _thumbnail_symbol)

    cfg = MODULE_CHECK
    sym = _thumbnail_symbol(cfg)
    mx.random.seed(0)
    train = SyntheticDataIter(cfg["classes"], (cfg["batch"], 3, cfg["size"],
                                               cfg["size"]), 2)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    losses = []
    before = kernels.entry("opt_sgd").kernel.launches
    mod.fit(train, num_epoch=1, kvstore=mx.kv.create("local"),
            optimizer="sgd",
            optimizer_params={"learning_rate": cfg["lr"],
                              "momentum": cfg["momentum"], "wd": cfg["wd"]},
            initializer=mx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2),
            batch_end_callback=lambda p: losses.append(_softmax_loss(
                mod.get_outputs()[0], train._label)))
    torch.cuda.synchronize()
    assert kernels.entry("opt_sgd").kernel.launches - before == 2
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    _, aux = mod.get_params()
    for name, arr in aux.items():
        init = 0.0 if name.endswith("mean") else 1.0
        assert not bool((arr._data == init).all()), name


# ---- training capture: steps, tables, the pair, the pair's generator ------

@pytest.mark.gpu
def test_a_captured_step_applies_one_update_per_call_on_card(cuda_device):
    """Five ``ShardedTrainer`` steps through site ``trainer`` (the first
    eager, then a capture that executes nothing, then four replays) and
    five eager steps from the same weights: the step counter, one K1
    launch and one flash backward pair per layer and step, and weights
    and momenta within 1e-3 of each tensor's L2 step of the eager run."""
    from mxnet_tpu_torch import compile as mxc
    from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

    x = mx.nd.array(_capture_tokens(8, seed=3))
    y = mx.nd.array(np.arange(8, dtype=np.float32) % 2)
    runs = {}
    for mode in ("captured", "eager"):
        clf = _capture_clf()
        st = ShardedTrainer(clf, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            "sgd", {"learning_rate": 0.05, "momentum": 0.9,
                                    "wd": 1e-4}, mesh=DeviceMesh({"dp": 1}))
        w0 = [h._data.clone() for h in st._train_handles]
        prev = mxc.set_enabled(mode == "captured")
        before = dict(mxc.stats().get("trainer", {"captures": 0,
                                                  "replays": 0}))
        kernels.reset_launch_counts()
        try:
            for _ in range(5):
                st.step(x, y)
        finally:
            mxc.set_enabled(prev)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        after = mxc.stats().get("trainer", {"captures": 0, "replays": 0})
        runs[mode] = ([h._data.clone() for h in st._train_handles],
                      [per[0].clone() for per in st._opt_state], w0)
        layers = CAPTURE_CFG["layers"]
        assert st._t == 5 and counts["opt_sgd"] == 5
        assert counts["flash_attention_bwd_dq"] == 5 * layers
        assert counts["flash_attention_bwd_dkv"] == 5 * layers
        assert (after["captures"] - before["captures"],
                after["replays"] - before["replays"]) == \
            ((1, 4) if mode == "captured" else (0, 0))
    for i, (a, b) in enumerate(zip(runs["captured"][0] + runs["captured"][1],
                                   runs["eager"][0] + runs["eager"][1])):
        ref = b - runs["eager"][2][i % len(runs["eager"][2])] \
            if i < len(runs["eager"][0]) else b
        scale = max(float(ref.norm()), 1e-12)
        assert float((a - b).norm()) <= 1e-3 * scale, i


@pytest.mark.gpu
def test_a_graph_holds_its_table_past_nine_parameter_sets_on_card(
        cuda_device):
    """A captured step launching K1 keeps its table (``kernels.keep``):
    after nine other parameter sets evict it from the family's cache of
    eight, each replay still updates the graph's tensors as the plain
    version does."""
    from mxnet_tpu_torch import compile as mxc
    from mxnet_tpu_torch.kernels import opt_step

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    shapes = [(1000,), (33, 7), (4096,)]

    def operands():
        return [[torch.randn(sh, device=cuda_device, generator=gen)
                 for sh in shapes] for _ in range(3)]

    ws, gs, ms = operands()
    lr = torch.tensor(0.1, device=cuda_device)
    wds = [1e-4] * len(shapes)

    def step():
        kernels.dispatch("opt_sgd", ws, gs, ms, lr, wds, momentum=0.9)
        return lr * 1

    fn = mxc.jit(step, site="test_card_step", token=("tables",),
                 reads=lambda: ws + gs + ms)
    want = [[t.clone() for t in group] for group in (ws, gs, ms)]
    fn()                               # eager: builds the table
    (entry,) = fn._seen.values()
    table = entry._counts.kept[0]
    tables = opt_step._TABLES["opt_sgd"]
    assert table in tables.by_key.values()
    others = [operands() for _ in range(9)]   # alive: nine new pointers
    for other in others:
        kernels.dispatch("opt_sgd", *other, lr, wds, momentum=0.9)
    assert table not in tables.by_key.values()
    plain = kernels.entry("opt_sgd").plain
    for _ in range(3):
        plain(want[0], want[1], want[2], lr, wds, momentum=0.9)
    fn()
    fn()                               # two replays over the held table
    torch.cuda.synchronize()
    for got, ref in zip(ws + ms, want[0] + want[2]):
        assert torch.equal(got, ref)


@pytest.mark.gpu
def test_a_table_miss_inside_a_capture_fills_the_table_after_it_on_card(
        cuda_device):
    """A step whose fused update reads a gradient allocated in the step
    (another address in the capture than in the eager first call) misses
    K1's table while capturing: through ``compile.jit`` the table is
    filled when the capture ends, and each replay updates as the plain
    version does; in a bare ``torch.cuda.graph`` capture, with no record
    to defer the upload to, the miss raises ``CaptureError`` naming
    ``opt_step``."""
    from mxnet_tpu_torch import compile as mxc

    w = torch.linspace(-1.0, 1.0, 64, device=cuda_device)
    m = torch.zeros(64, device=cuda_device)
    lr = torch.tensor(0.1, device=cuda_device)
    want = [w.clone(), m.clone()]

    def step():
        g = w * 0.5 + 1.0
        kernels.dispatch("opt_sgd", [w], [g], [m], lr, [1e-4], momentum=0.9)
        return w.sum()

    fn = mxc.jit(step, site="test_card_step", token=("miss",),
                 reads=lambda: [w, m])
    plain = kernels.entry("opt_sgd").plain
    for _ in range(4):
        fn()                           # eager, then a capture and replays
        plain([want[0]], [want[0] * 0.5 + 1.0], [want[1]], lr, [1e-4],
              momentum=0.9)
    torch.cuda.synchronize()
    assert torch.equal(w, want[0]) and torch.equal(m, want[1])

    graph = torch.cuda.CUDAGraph()
    with pytest.raises(mxc.CaptureError, match="opt_step"):
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            g = torch.full_like(w, 2.0)
            kernels.dispatch("opt_sgd", [w], [g], [m], lr, [0.0],
                             momentum=0.9)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_create_graph_through_a_captured_pair_raises_on_card(cuda_device):
    """The captured pair is differentiable once, as the JAX package's
    hybridized node: ``autograd.grad(..., create_graph=True)`` through
    a replayed forward raises instead of returning gradients cut off
    from the graph; a first-order backward after it still works."""
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(32, in_units=16, activation="tanh"),
                nn.Dense(1, in_units=32))
    net.initialize(mx.init.Xavier())
    net.hybridize()
    x = mx.nd.array(np.random.RandomState(0).rand(8, 16).astype(np.float32))
    x.attach_grad()
    for _ in range(2):                 # the eager first call, the capture
        with mx.autograd.record():
            out = net(x).sum()
        out.backward()
    with mx.autograd.record():
        out = net(x).sum()
    with pytest.raises(NotImplementedError, match="create_graph"):
        mx.autograd.grad(out, [x], create_graph=True)
    with mx.autograd.record():
        out = net(x).sum()
    out.backward()
    assert bool(torch.isfinite(x.grad._data).all())


@pytest.mark.gpu
def test_a_returned_input_gradient_survives_the_next_step_on_card(
        cuda_device):
    """``autograd.grad`` with respect to a replayed pair's input and to a
    parameter returns tensors of the caller's own: the next replayed
    backward, on another batch, leaves them as they were, and each
    equals the eager gradient."""
    from mxnet_tpu_torch import compile as mxc
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(32, in_units=16, activation="tanh"),
                nn.Dense(4, in_units=32))
    net.initialize(mx.init.Xavier())
    weight = next(p for p in net.collect_params().values()
                  if p.name.endswith("weight"))
    rs = np.random.RandomState(1)
    xs = [mx.nd.array(rs.rand(8, 16).astype(np.float32)) for _ in range(4)]

    def grads():
        got = []
        for x in xs:
            x.attach_grad()
            with mx.autograd.record():
                y = net(x)
                out = (y * y).sum()
                w = weight.data()
            got += [g._data for g in mx.autograd.grad(out, [x, w])]
        return got

    prev = mxc.set_enabled(False)
    try:
        want = [g.clone() for g in grads()]
    finally:
        mxc.set_enabled(prev)
    net.hybridize()
    replays0 = mxc.stats().get("cachedop", {"replays": 0})["replays"]
    got = grads()              # eager, then captured and replayed
    torch.cuda.synchronize()
    assert mxc.stats()["cachedop"]["replays"] - replays0 == 2 * 3
    assert len({g.data_ptr() for g in got}) == len(got)
    for g, ref in zip(got, want):
        assert torch.allclose(g, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_dropout_draws_anew_at_each_replay_on_card(cuda_device):
    """A hybridized block with Dropout(0.5) under ``record()``: the pair
    replays draw a new mask each call from the registered generator;
    ``mx.random.seed`` twice gives the same masks."""
    from mxnet_tpu_torch import compile as mxc
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(256, in_units=256), nn.Dropout(0.5))
    net.initialize(mx.init.One())
    net.hybridize()
    x = mx.nd.array(np.ones((64, 256), np.float32))
    runs = []
    for _ in range(2):
        mx.random.seed(7)
        masks = []
        for _ in range(5):
            with mx.autograd.record():
                out = net(x)
            out.backward()
            masks.append((out._data == 0).clone())
        runs.append(masks)
    assert mxc.stats()["cachedop"]["replays"] > 0
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0], runs[0][1:]):
        assert not torch.equal(a, b)
    for mk in runs[0]:
        share = float(mk.float().mean())
        assert abs(share - 0.5) < 3 * math.sqrt(0.25 / mk.numel())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_causal_flash_at_the_lm_shape_matches_plain_on_card(cuda_device,
                                                             dtype):
    """K3 and K3-bwd causal at ``transformer_lm``'s GPT-2-small shape
    (8, 12, 1024, 1024, 64), on the tensor-core path, against their plain
    versions (f32 2e-5, bf16 2e-2); the first and the last query tiles
    (the least and the most causal work) are held on their own too."""
    b, h, s, d = 8, 12, 1024, 64
    q, k, v, do = (torch.from_numpy(_rand((b, h, s, d), seed)).to(
        cuda_device, dtype) for seed in (21, 22, 23, 24))
    scale = 1 / math.sqrt(d)
    fwd_paths = dict(flash.flash_forward.launches_by_path)
    o, lse = flash.flash_forward(q, k, v, scale, True, with_lse=True)
    dq, dsum = flash.flash_backward_dq(q, k, v, o, lse, do, scale, True)
    dk, dv = flash.flash_backward_dkv(q, k, v, lse, dsum, do, scale, True)
    torch.cuda.synchronize()
    assert flash.flash_forward.launches_by_path["mma"] == \
        fwd_paths["mma"] + 1
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    want_o = flash.flash_attention_plain(q, k, v, scale, True)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=tol, atol=tol)
    for rows in (slice(0, 64), slice(s - 64, s)):
        torch.testing.assert_close(o[:, :, rows].float(),
                                   want_o[:, :, rows].float(), rtol=tol,
                                   atol=tol)
    want = flash.flash_backward_plain(q, k, v, o, do, scale, True)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_c10_a_dropped_captured_trainer_returns_its_pool_on_card(
        cuda_device):
    """Fault C10: with the cyclic collector off, dropping a captured
    trainer (and its network) frees its step's graph and memory pool:
    ``memory_reserved`` falls after ``empty_cache``, with no
    ``gc.collect``."""
    import gc

    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

    def trainer():
        net = nn.HybridSequential()
        net.add(nn.Dense(2048, in_units=2048, activation="relu"),
                nn.Dense(2048, in_units=2048))
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        return ShardedTrainer(net, mx.gluon.loss.L2Loss(), "adam",
                              {"learning_rate": 1e-3},
                              mesh=DeviceMesh({"dp": 1}))

    x = mx.nd.array(_rand((4096, 2048), 31), ctx=mx.gpu(0))
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        st = trainer()
        for _ in range(3):   # eager first call, capture, replays
            st.step(x, x)
        torch.cuda.synchronize()
        held = torch.cuda.memory_reserved()
        pools = st._step_fn.stats()["entries"]
        del st
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_reserved()
    finally:
        if was:
            gc.enable()
    assert pools and pools[0]["kind"] == "forward"
    assert held - base > 64 << 20
    assert after - base < (held - base) / 8, (base, held, after)


@pytest.mark.gpu
def test_a_captured_remat_step_draws_the_eager_steps_dropout_masks_on_card(
        cuda_device):
    """``transformer_lm``'s LM (2 small causal cells, Dropout 0.1) with
    ``remat=True``: three captured steps (the first eager, then a
    capture and two replays, the recomputed forward drawing from the
    recomputation state) against three eager ``remat=True`` steps and
    three eager ``remat=False`` steps from the same weights and seed: the
    same losses and weights, bit for bit, so every recomputed Dropout
    mask was the forward's."""
    from chip_smoke import build_lm
    from mxnet_tpu_torch import compile as mxc
    from mxnet_tpu_torch.parallel import ShardedTrainer

    cfg = {"vocab": 96, "units": 64, "hidden": 128, "layers": 2, "heads": 4,
           "seq_len": 64}
    rs = np.random.RandomState(3)
    xs = [(mx.nd.array(rs.randint(0, 96, (4, 64)).astype(np.float32),
                       ctx=mx.gpu(0)),
           mx.nd.array(rs.randint(0, 96, (4, 64)).astype(np.float32),
                       ctx=mx.gpu(0))) for _ in range(3)]
    ref = None
    runs = []
    for remat, captured in ((True, True), (True, False), (False, False)):
        net, adapter, loss = build_lm(mx, cfg, dropout=0.1, ctx=mx.gpu(0))
        net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
        net(xs[0][0], mx.nd.arange(64, ctx=mx.gpu(0)))
        if ref is None:
            ref = {n: p.data().asnumpy()
                   for n, p in net._collect_params_with_structure().items()}
        for n, p in net._collect_params_with_structure().items():
            p.set_data(mx.nd.array(ref[n], ctx=mx.gpu(0)))
        st = ShardedTrainer(adapter, loss, "adam", {"learning_rate": 1e-3},
                            remat=remat)
        prev = mxc.set_enabled(captured)
        try:
            mx.random.seed(5)
            losses = [float(st.step(x, y).asscalar()) for x, y in xs]
        finally:
            mxc.set_enabled(prev)
        if captured:
            assert st._step_fn.stats()["replays"] == 2
        runs.append((losses, {n: p.data().asnumpy() for n, p in
                              net._collect_params_with_structure().items()}))
    for losses, params in runs[1:]:
        assert losses == runs[0][0]
        for n in params:
            np.testing.assert_array_equal(params[n], runs[0][1][n],
                                          err_msg=n)


@pytest.mark.gpu
def test_native_io_build_holds_its_plain_versions(cuda_device, tmp_path):
    """The native IO library as built on the card's machine: each entry
    point bit for bit against its plain version; a JPEG payload raises
    naming libjpeg where the build has none; the card's ImageRecordIter
    batches (pinned copies on the consumer's stream) equal the CPU run over
    the plain versions."""
    import zlib

    from chip_smoke import smooth_image
    from mxnet_tpu_torch import native

    st = native.status()
    assert st["available"], st["error"]
    rs = np.random.RandomState(1)
    imgs = [smooth_image(int(rs.randint(1 << 30)), h, w, 4.0)
            for h, w in ((64, 85), (85, 64), (31, 47))]
    for i, im in enumerate(imgs):
        buf = native.png_encode(im, i % 2)
        info = native.png_info(buf)
        assert info._replace(idat=bytes(info.idat)) == \
            native.png_info_plain(buf)
        raw = native.png_inflate(info)
        assert raw == zlib.decompress(info.idat)
        assert np.array_equal(native.png_to_rgb(raw, info), im)
        assert np.array_equal(native.png_to_rgb_plain(raw, info), im)
        h, w = im.shape[:2]
        assert np.array_equal(native.resample_bilinear(im, h - 5, w + 3),
                              native.resample_bilinear_plain(im, h - 5,
                                                             w + 3))
        jit = np.asarray([0.8, 1.0, 1.2], np.float32)
        assert np.array_equal(
            native.png_decode_augment(raw, info, 40, 40, 32, 32, 3, 5, 1,
                                      jit),
            native.augment_plain(native.resample_bilinear_plain(
                im, 40, 40), 3, 5, 32, 32, True, jit))
    batch = np.stack([im[:31, :47] for im in imgs])
    mean = np.asarray([1.0, 2.0, 3.0], np.float32)
    std = np.asarray([58.4, 57.1, 57.4], np.float32)
    assert np.array_equal(native.normalize_batch(batch, mean, std),
                          native.normalize_batch_plain(batch, mean, std))
    if not st["jpeg"]:
        with pytest.raises(mx.MXNetError, match="libjpeg"):
            native.decode_jpeg_batch([b"\xff\xd8\xff\xe0" + bytes(32)], 8, 8)
    path = str(tmp_path / "r.rec")
    w = mx.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(12):
        w.write_idx(i, mx.recordio.pack_img(
            (0, float(i), i, 0), smooth_image(i, 40 + i, 50 - i, 4.0),
            img_fmt=".png"))
    w.close()
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=4,
              shuffle=True, rand_crop=True, rand_mirror=True,
              color_jitter=0.2, mean_r=123.0, std_b=57.0)
    card = [(b.data[0], b.label[0]) for b in mx.io.ImageRecordIter(
        ctx=mx.gpu(0), **kw)]
    assert all(d.context == mx.gpu(0) for d, _ in card)
    with native.plain_versions():
        cpu = [(b.data[0].asnumpy(), b.label[0].asnumpy())
               for b in mx.io.ImageRecordIter(ctx=mx.cpu(), **kw)]
    assert len(card) == len(cpu) == 3
    for (d, lb), (dc, lc) in zip(card, cpu):
        assert np.array_equal(d.asnumpy(), dc)
        assert np.array_equal(lb.asnumpy(), lc)


def _swap_model():
    from mxnet_tpu_torch import serving

    model = serving.ServedModel.from_block(
        "swap", _capture_clf(), example_shape=(CAPTURE_CFG["seq_len"],),
        buckets=(2, 4, 8))
    model.warmup()
    return model


def _scaled(model, factor):
    """The model's parameters times ``factor``, as host arrays."""
    return [t.detach().cpu().numpy() * np.float32(factor)
            for t in model.pinned()[0]]


@pytest.mark.gpu
def test_swap_params_on_a_captured_ladder_on_card(cuda_device, monkeypatch):
    """A swap writes new values into the tensors the bucket graphs read:
    the output changes to that of a block holding the new values, no
    bucket is captured again, the snapshot keeps its storage, and the
    copy into it runs on the replay stream; swapping the old values back
    gives the old output bit for bit."""
    from mxnet_tpu_torch import compile as mxc

    model = _swap_model()
    captures = model.capture_stats()["captures"]
    misses = mxc.stats()["serving"]["misses"]
    x = np.zeros((4, CAPTURE_CFG["seq_len"]), np.float32)
    x[:3] = _capture_tokens(3, seed=41)
    before = model.run(x, 3)[0]
    old, new = _scaled(model, 1.0), _scaled(model, 1.25)
    ptrs = [t.data_ptr() for t in model.pinned()[0]]
    streams, real = [], torch._foreach_copy_

    def spy(dst, src, **kw):
        if [t.data_ptr() for t in dst] == ptrs:   # a copy into the snapshot
            streams.append(torch.cuda.current_stream())
        return real(dst, src, **kw)

    monkeypatch.setattr(torch, "_foreach_copy_", spy)
    model.swap_params(new, 1)
    after, version = model.run_versioned(x, 3)
    assert streams == [model.replay_stream] and version == 1
    assert not np.allclose(after[0], before)
    ref = _capture_clf()
    for p, a in zip(ref.collect_params().values(), new):
        p.set_data(a)
    with torch.inference_mode():
        want = ref(mx.nd.array(x[:3])).asnumpy()
    np.testing.assert_allclose(after[0], want, rtol=1e-4, atol=1e-4)
    model.swap_params(old, 2)
    np.testing.assert_array_equal(model.run(x, 3)[0], before)
    assert [t.data_ptr() for t in model.pinned()[0]] == ptrs
    assert model.capture_stats()["captures"] == captures
    assert mxc.stats()["serving"]["misses"] == misses
    assert (model.version, model.swaps) == (2, 2)


@pytest.mark.gpu
def test_swaps_racing_replays_never_tear_a_batch_on_card(cuda_device):
    """Two threads replay a bucket while the main thread swaps two value
    sets back and forth: every batch equals, bit for bit, the output of
    the set its stamped version names (odd versions the scaled set, even
    the original)."""
    import threading

    model = _swap_model()
    x = np.zeros((8, CAPTURE_CFG["seq_len"]), np.float32)
    x[:7] = _capture_tokens(7, seed=42)
    sets = {0: _scaled(model, 1.0), 1: _scaled(model, 1.25)}
    want = {}
    for v in (1, 2):
        model.swap_params(sets[v % 2], v)
        want[v % 2] = model.run(x, 7)[0]
    assert not np.array_equal(want[0], want[1])
    stop, bad, seen = threading.Event(), [], [0]

    def replays():
        while not stop.is_set():
            out, v = model.run_versioned(x, 7)
            if not np.array_equal(out[0], want[v % 2]):
                bad.append(v)
            seen[0] += 1

    threads = [threading.Thread(target=replays) for _ in range(2)]
    for t in threads:
        t.start()
    for v in range(3, 43):
        model.swap_params(sets[v % 2], v)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    assert not bad and seen[0] > 0 and model.version == 42


@pytest.mark.gpu
def test_two_swappers_racing_replays_never_mix_versions_on_card(
        cuda_device):
    """Two threads swap two value sets (odd versions the scaled set, even
    the original) into the shared staging sets while two threads replay a
    bucket: every batch equals, bit for bit, the output of the set its
    stamped version names, and the last stamp names the values left."""
    import threading

    model = _swap_model()
    x = np.zeros((8, CAPTURE_CFG["seq_len"]), np.float32)
    x[:7] = _capture_tokens(7, seed=43)
    sets = {0: _scaled(model, 1.0), 1: _scaled(model, 1.25)}
    want = {}
    for v in (1, 2):
        model.swap_params(sets[v % 2], v)
        want[v % 2] = model.run(x, 7)[0]
    assert not np.array_equal(want[0], want[1])
    stop, bad, seen = threading.Event(), [], [0]

    def replays():
        while not stop.is_set():
            out, v = model.run_versioned(x, 7)
            if not np.array_equal(out[0], want[v % 2]):
                bad.append(v)
            seen[0] += 1

    def swaps(first):
        for v in range(first, 83, 2):
            model.swap_params(sets[v % 2], v)

    readers = [threading.Thread(target=replays) for _ in range(2)]
    swappers = [threading.Thread(target=swaps, args=(f,)) for f in (3, 4)]
    for t in readers + swappers:
        t.start()
    for t in swappers:
        t.join(timeout=120)
    stop.set()
    for t in readers:
        t.join(timeout=120)
    assert not bad and seen[0] > 0 and model.swaps == 82
    out, v = model.run_versioned(x, 7)
    assert np.array_equal(out[0], want[v % 2])


# ------------------------------------------------------ recurrent stack ---

@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_cudnn_route_matches_the_per_step_form_on_card(cuda_device,
                                                           mode):
    """The RNN op's cuDNN route against its per-step form (the plain
    version) on the card, TF32 off: 1 and 2 layers, one and two
    directions, forward within chip_smoke.RNN_TOL (rtol = atol) and
    gradients within RNN_TOL of each tensor's largest value."""
    from chip_smoke import RNN_TOL, _rnn_errors, rnn_route_pair

    torch.backends.cudnn.allow_tf32 = False
    for layers, bi in ((1, False), (2, False), (2, True)):
        (o_c, g_c), (o_s, g_s) = rnn_route_pair(mode, layers, bi,
                                                (7, 3, 5, 16), cuda_device)
        for what, got, want in (("forward", o_c, o_s),
                                ("gradients", g_c, g_s)):
            err, ratio = _rnn_errors(got, want, what == "gradients")
            assert ratio <= 1, (mode, layers, bi, what, err, RNN_TOL)


@pytest.mark.gpu
def test_rnn_op_routes_by_device_on_card(cuda_device):
    """CUDA tensors take cuDNN, or the per-step form with LSTM state
    clipping (counted in ``rnn_routes``); CPU tensors the plain version;
    a mix raises."""
    from mxnet_tpu_torch.ops import nn as nn_ops

    x, p = torch.randn(4, 2, 3), torch.randn(
        nn_ops.rnn_param_size(3, 5)) * 0.3
    h, c = torch.zeros(1, 2, 5), torch.zeros(1, 2, 5)
    want = nn_ops._rnn(x, p, h, c, state_size=5,
                       lstm_state_clip_min=-0.1, lstm_state_clip_max=0.1)
    nn_ops.rnn_routes.reset()
    torch.backends.cudnn.allow_tf32 = False
    on = [t.to(cuda_device) for t in (x, p, h, c)]
    plain = nn_ops._rnn(*on, state_size=5)
    clipped = nn_ops._rnn(*on, state_size=5, lstm_state_clip_min=-0.1,
                          lstm_state_clip_max=0.1)
    assert nn_ops.rnn_routes.calls == {"cudnn": 1, "steps": 1}
    for g, w in zip(clipped, want):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-5, atol=2e-5)
    assert plain[0].shape == (4, 2, 5)
    with pytest.raises(kernels.DeviceError):
        nn_ops._rnn(on[0], p, h, c, state_size=5)


def _lstm_net(cuda_device):
    from mxnet_tpu_torch.gluon import rnn

    mx.random.seed(0)
    layer = rnn.LSTM(32, num_layers=2, input_size=16)
    layer.initialize(mx.init.Xavier(), ctx=mx.gpu(0),
                     generator=torch.Generator().manual_seed(0))
    return layer


@pytest.mark.gpu
def test_a_hybridized_lstm_captures_and_replays_its_pair_on_card(
        cuda_device):
    """cuDNN's RNN forward and backward inside the ``cachedop`` pair: the
    second call captures, later calls replay, and a replay's outputs,
    states and gradients equal the eager forward and backward of the
    same weights (no tolerance: the same kernels on the same inputs).
    The eager call keeps no autograd graph alive: one alive from the
    default stream makes the capture's backward wait on that stream,
    which CUDA refuses during a capture."""
    from mxnet_tpu_torch import compile as compile_service

    torch.backends.cudnn.allow_tf32 = False
    layer = _lstm_net(cuda_device)
    layer.hybridize()
    gen = torch.Generator().manual_seed(1)
    x = nd.array(torch.randn(10, 4, 16, generator=gen), ctx=mx.gpu(0))
    st = [nd.array(torch.randn(4, 4, 32, generator=gen), ctx=mx.gpu(0))
          for _ in range(2)]

    def call():
        with mx.autograd.record():
            out, states = layer(x, st)
            loss = (out * out).sum() + states[0].sum() + states[1].sum()
        loss.backward()
        grads = [p.grad()._data.clone()
                 for p in layer.collect_params().values()]
        return [t._data.detach().clone() for t in [out] + states], grads

    want = _eager(call)
    before = compile_service.stats().get("cachedop", {}).get("captures", 0)
    got = [call() for _ in range(4)]
    stats = compile_service.stats()["cachedop"]
    assert stats["captures"] - before == 1
    for outs, grads in got[1:]:
        for g, w in zip(outs + grads, want[0] + want[1]):
            assert torch.equal(g, w)


@pytest.mark.gpu
def test_the_tied_gradient_sums_both_parts_in_a_captured_pair_on_card(
        cuda_device):
    """word_lm.py's tied RNNModel hybridized: the replayed pair's
    gradient of the shared matrix equals the embedding's and the
    decoder's parts computed apart by an untied copy (dropout 0)."""
    from chip_smoke import word_lm_model
    from mxnet_tpu_torch import gluon

    torch.backends.cudnn.allow_tf32 = False
    RNNModel = word_lm_model(mx)
    dev = mx.gpu(0)
    tied = RNNModel(50, 16, 16, 2, dropout=0.0, tie_weights=True)
    tied.initialize(mx.init.Xavier(), ctx=dev,
                    generator=torch.Generator().manual_seed(0))
    untied = RNNModel(50, 16, 16, 2, dropout=0.0)
    untied.initialize(ctx=dev)
    tied.hybridize()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(0)
    x = nd.array(rng.randint(0, 50, (5, 4)).astype(np.float32), ctx=dev)
    y = nd.array(rng.randint(0, 50, (5, 4)).astype(np.float32), ctx=dev)

    def grads(net):
        with mx.autograd.record():
            out, _ = net(x, net.begin_state(4, dev))
            loss = loss_fn(out.reshape((-1, 50)), y.reshape((-1,)))
        loss.backward()
        return {n: p.grad(dev)._data.clone() for n, p in
                net._collect_params_with_structure().items()}

    for _ in range(3):           # eager, capture, replay
        got = grads(tied)["encoder.weight"]
    src = tied._collect_params_with_structure()
    for name, p in untied._collect_params_with_structure().items():
        p.set_data(src[name].data())
    parts = grads(untied)
    torch.testing.assert_close(
        got, parts["encoder.weight"] + parts["decoder.weight"],
        rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_four_buckets_capture_over_one_storage_on_card(cuda_device):
    """train_ptb.py's sym_gen at a small width through BucketingModule:
    each of four buckets captures its executor pair once (at its second
    batch), every bucket computes in the default bucket's parameter and
    gradient tensors, one updater serves all, and K2 launches once a
    batch."""
    from chip_smoke import bucket_sentence_iter, sym_gen_factory
    from mxnet_tpu_torch import compile as compile_service

    dev = mx.gpu(0)
    rng = np.random.RandomState(0)
    sentences = [list(rng.randint(1, 50, n)) + [0]
                 for n in rng.randint(5, 35, 160)]
    it = bucket_sentence_iter(mx)(sentences, 4, [10, 20, 30, 40], 50)
    model = mx.mod.BucketingModule(sym_gen_factory(mx, 50, 8, 16, 4),
                                   default_bucket_key=40, context=dev)
    model.bind(it.provide_data, it.provide_label)
    model.init_params(mx.init.Xavier())
    model.init_optimizer(optimizer="adam",
                         optimizer_params={"learning_rate": 0.01})
    before = compile_service.stats().get("executor", {}).get("captures", 0)
    kernels.reset_launch_counts()
    n = 0
    for batch in it:
        model.forward_backward(batch)
        model.update()
        n += 1
    caps = compile_service.stats()["executor"]["captures"] - before
    assert caps == 4 and sorted(model._buckets) == [10, 20, 30, 40]
    assert kernels.launch_counts()["opt_adam"] == n
    default = model._buckets[40]
    for mod in model._buckets.values():
        assert mod._updater is default._updater
        for name in mod._param_names:
            for d in ("arg_dict", "grad_dict"):
                assert getattr(mod._exec, d)[name]._data.data_ptr() == \
                    getattr(default._exec, d)[name]._data.data_ptr()


def _rule_trainer(name, device, seed=0):
    from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

    ctx = mx.gpu(0) if device.type == "cuda" else mx.cpu()
    net = mx.gluon.nn.HybridSequential(prefix="r_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(64, activation="tanh", in_units=32),
                mx.gluon.nn.Dense(8, in_units=64))
    net.initialize(mx.init.Xavier(), ctx=ctx,
                   generator=torch.Generator().manual_seed(seed))
    return ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), name,
                          {"learning_rate": 0.01, "wd": 1e-3,
                           "clip_gradient": 1.0},
                          mesh=DeviceMesh({"dp": 1}, devices=[ctx]),
                          nan_guard=False)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["lamb", "nadam"])
def test_captured_rule_steps_replay_without_host_syncs(cuda_device, name):
    """Steps 3-7 of a captured trainer (the first eager, the second
    captured) replay with the host never waiting on the card, and equal
    the same seven steps run eagerly from the same weights within 1e-6 of
    each tensor's L2 norm (a replay runs the eager step's kernels on the
    same operands; bit for bit is what is expected)."""
    from mxnet_tpu_torch import compile as compile_service

    rs = np.random.RandomState(1)
    batches = [(rs.randn(16, 32).astype(np.float32),
                rs.randint(0, 8, 16).astype(np.float32)) for _ in range(7)]
    ctx = mx.gpu(0)
    runs = {}
    for mode in ("captured", "eager"):
        st = _rule_trainer(name, cuda_device)
        prev = compile_service.set_enabled(mode == "captured")
        try:
            for i, (x, y) in enumerate(batches):
                xb, yb = mx.nd.array(x, ctx=ctx), mx.nd.array(y, ctx=ctx)
                if mode == "captured" and i >= 2:
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        st.step(xb, yb)
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                else:
                    st.step(xb, yb)
        finally:
            compile_service.set_enabled(prev)
        torch.cuda.synchronize()
        runs[mode] = [t.clone() for t in st._state_tensors().values()]
    for got, want in zip(runs["captured"], runs["eager"]):
        err = float((got - want).norm())
        assert err <= 1e-6 * max(float(want.norm()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 1), num_filter=6,
         num_group=2),
    dict(kernel=(4, 4), stride=(2, 2), num_filter=3, num_group=1,
         target_shape=(10, 9)),
    dict(kernel=(3, 3), stride=(1, 1), dilate=(2, 2), num_filter=8,
         num_group=8),
])
def test_deconvolution_on_card_equals_cpu(cuda_device, kw):
    torch.backends.cudnn.allow_tf32 = False
    cin = 8 if kw["num_group"] == 8 else (4 if kw["num_group"] == 2 else 2)
    x = _rand((2, cin, 5, 5), 1)
    w = _rand((cin, kw["num_filter"] // kw["num_group"]) + kw["kernel"], 2)
    head = None
    grads = {}
    for dev in ("cpu", cuda_device):
        xt = torch.tensor(x, device=dev, requires_grad=True)
        wt = torch.tensor(w, device=dev, requires_grad=True)
        out = reg.get("Deconvolution")(xt, wt, **kw)
        if head is None:
            head = torch.tensor(_rand(tuple(out.shape), 3))
        out.backward(head.to(dev))
        grads[str(dev)] = [out.detach().cpu(), xt.grad.cpu(), wt.grad.cpu()]
    for a, b in zip(grads[str(cuda_device)], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.gpu
def test_ctc_loss_on_card_matches_the_plain_recursion(cuda_device):
    """The card's route (``torch.nn.functional.ctc_loss``, no clamp of
    infinite losses) against the plain log-space recursion on the card
    and on the CPU, losses and gradients, with the blank first (labels
    padded with 0) and last (padded with -1), data lengths and label
    lengths."""
    from mxnet_tpu_torch.ops import nn as nn_ops

    rs = np.random.RandomState(0)
    data = rs.randn(40, 6, 12).astype(np.float32)
    for blank_label in ("first", "last"):
        pad = 0 if blank_label == "first" else -1
        label = rs.randint(1, 11, (6, 8)).astype(np.float32)
        if blank_label == "last":
            label -= 1
        for i, n in enumerate((8, 5, 1, 3, 8, 6)):
            label[i, n:] = pad
        dlen = np.array([40, 33, 20, 40, 38, 25], np.float32)
        res = []
        for dev, route in ((cuda_device, "torch"), (cuda_device, "plain"),
                           ("cpu", "plain")):
            d = torch.tensor(data, device=dev, requires_grad=True)
            lab = torch.tensor(label, device=dev)
            dl = torch.tensor(dlen, device=dev)
            if route == "torch":
                loss = reg.get("CTCLoss")(d, lab, dl, use_data_lengths=True,
                                          blank_label=blank_label)
            else:
                blank = 0 if blank_label == "first" else 11
                lab64 = lab.to(torch.int64)
                loss = nn_ops.ctc_plain(
                    torch.log_softmax(d, -1), lab64,
                    nn_ops.ctc_lengths(lab64, blank_label), dl.to(
                        torch.int64), blank)
            (g,) = torch.autograd.grad(loss.sum(), [d])
            res.append((loss.detach().cpu(), g.cpu()))
        for loss, g in res[1:]:
            torch.testing.assert_close(res[0][0], loss, rtol=1e-5,
                                       atol=1e-4)
            torch.testing.assert_close(res[0][1], g, rtol=1e-4, atol=1e-5)


SAMPLERS = {
    "gamma": lambda n: nd.random.gamma(2.5, 1.5, shape=(n,)),
    "exponential": lambda n: nd.random.exponential(3.0, shape=(n,)),
    "poisson": lambda n: nd.random.poisson(3.0, shape=(n,)),
    "negative_binomial": lambda n: nd.random.negative_binomial(
        4, 0.3, shape=(n,)),
    "randint": lambda n: nd.random.randint(-3, 7, shape=(n,)),
    "bernoulli": lambda n: nd.random.bernoulli(0.2, shape=(n,)),
    "multinomial": lambda n: nd.random.multinomial(
        nd.ones((4, 50)), shape=(n // 4,)),
    "shuffle": lambda n: nd.random.shuffle(nd.arange(n)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_replay_draws_what_the_eager_call_draws(name, cuda_device):
    from mxnet_tpu_torch import compile as mxc

    draw = SAMPLERS[name]
    gen = mx.random.generator(cuda_device)
    zero = torch.zeros((), device=cuda_device)

    def body(t):
        return draw(4096)._data

    with mx.gpu(0):
        f = mxc.jit(body, site="card_test", token=("sampler", name))
        f(zero)                       # eager, then the capture
        state = gen.get_state()
        eager = body(zero)
        gen.set_state(state)
        replay = f(zero)
        again = f(zero)
    assert f.stats()["captures"] == 1 and f.stats()["replays"] == 2
    assert torch.equal(replay, eager)
    assert not torch.equal(again, replay)


@pytest.mark.gpu
def test_potrf_of_a_matrix_not_positive_definite_inside_a_graph(cuda_device):
    from mxnet_tpu_torch import compile as mxc

    rs = np.random.RandomState(0)
    m = rs.randn(3, 32, 32)
    spd = m @ m.transpose(0, 2, 1) / 32 + np.eye(32)
    spd[1] = -spd[1]
    x = torch.tensor(spd, dtype=torch.float32, device=cuda_device)
    f = mxc.jit(lambda t: nd.linalg_potrf(nd.NDArray(t))._data,
                site="card_test", token=("potrf",))
    f(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = f(x)
        direct = nd.linalg_potrf(nd.NDArray(x))._data
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert f.stats()["captures"] == 1
    lower = torch.ones(32, 32, dtype=torch.bool, device=cuda_device).tril()
    for out in (got, direct):
        assert torch.equal(torch.isnan(out[1]), lower)
        want = torch.linalg.cholesky(torch.tensor(spd[[0, 2]]))
        torch.testing.assert_close(out[[0, 2]].double().cpu(), want,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_a_hybridized_custom_op_runs_uncaptured_on_the_card(cuda_device):
    from mxnet_tpu_torch import compile as mxc

    class Twice(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()           # a host read
            self.assign(out_data[0], req[0], nd.array(2 * x))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 2)

    @mx.operator.register("card_test_twice")
    class TwiceProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Twice()

    class Block(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.Custom(x + 1, op_type="card_test_twice")

    block = Block()
    block.hybridize()
    x = nd.array(np.arange(6, dtype=np.float32), ctx=mx.gpu(0))
    before = dict(mxc.stats().get("cachedop", {}).get("uncaptured", {}))
    for _ in range(3):
        y = block(x)
    x.attach_grad()
    with mx.autograd.record():
        z = block(x)
    z.backward()
    st = mxc.stats()["cachedop"]
    reason = "host op Custom(op_type='card_test_twice')"
    assert st["uncaptured"][reason] - before.get(reason, 0) == 4
    assert y._data.device.type == "cuda"
    assert torch.equal(y._data.cpu(), 2 * (torch.arange(6.0) + 1))
    assert torch.equal(x.grad._data.cpu(), torch.full((6,), 2.0))


def _la_cases(dev, dtype):
    """``{op: (inputs, hyper-parameters)}``: every ``la_op`` op and
    ``tensor.py``'s linear-algebra ops on a batch of 4 SPD 64 x 64
    matrices, their Cholesky factors and right-hand sides."""
    rs = np.random.RandomState(0)
    m = rs.randn(4, 64, 64)
    spd = m @ m.transpose(0, 2, 1) / 64 + np.eye(64)
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)  # noqa: E731
    a, low = t(spd), t(np.linalg.cholesky(spd))
    rhs = t(rs.randn(4, 64, 16))
    return {
        "linalg_gemm": ((a, rhs, rhs), {}),
        "linalg_gemm2": ((rhs, rhs), {"transpose_a": True}),
        "linalg_potrf": ((a,), {}),
        "linalg_potri": ((low,), {}),
        "linalg_trmm": ((low, rhs), {}),
        "linalg_trsm": ((low, rhs), {"transpose": True}),
        "linalg_syrk": ((rhs,), {"transpose": True}),
        "linalg_gelqf": ((a[:, :16, :],), {}),
        "linalg_syevd": ((a,), {}),
        "linalg_sumlogdiag": ((low,), {}),
        "linalg_extractdiag": ((a,), {"offset": 1}),
        "linalg_makediag": ((rhs[:, :, 0],), {"offset": -1}),
        "linalg_extracttrian": ((low,), {}),
        "linalg_maketrian": ((t(rs.randn(4, 2080)),), {}),
        "linalg_det": ((a[:, :16, :16],), {}),
        "linalg_slogdet": ((a,), {}),
        "linalg_inverse": ((a,), {}),
        "khatri_rao": ((rhs[0, :8], rhs[1, :12]), {}),
    }


def _la_forward_backward(name, args, kwargs):
    """The op's outputs and the gradients of their sum (weighted by 1 +
    each element's index, so no gradient is trivially uniform) with
    respect to every input."""
    from mxnet_tpu_torch.ops import registry as reg

    ins = [a.detach().clone().requires_grad_(True) for a in args]
    outs = reg.get(name)(*ins, **kwargs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o * torch.arange(o.numel(), device=o.device,
                                  dtype=o.dtype).reshape(o.shape).add(1)
                 / o.numel()).sum() for o in outs)
    grads = torch.autograd.grad(total, ins, allow_unused=True)
    return list(outs) + [g for g in grads if g is not None]


LA_OPS = [n for n in _la_cases("cpu", torch.float64) if n != "linalg_syevd"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", LA_OPS)
def test_la_op_captures_forward_and_backward_with_no_host_sync(
        name, dtype, cuda_device):
    """Each linear-algebra op but ``linalg_syevd`` (the next test), forward
    and gradient, eagerly under ``set_sync_debug_mode("error")`` and
    inside a raw CUDA graph: the replay equals the eager result."""
    args, kwargs = _la_cases(cuda_device, dtype)[name]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _la_forward_backward(name, args, kwargs)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager = _la_forward_backward(name, args, kwargs)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = _la_forward_backward(name, args, kwargs)
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert len(captured) == len(eager)
    for got, want in zip(captured, eager):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_syevd_is_a_host_op_that_runs_uncaptured(cuda_device):
    """``linalg_syevd`` (``torch.linalg.eigh``) syncs with the host, so it
    is a host op: a ``compile.jit`` body holding it runs uncaptured under
    its reason, and a raw capture that meets it raises
    ``HostOpInCapture`` before cuSOLVER is called."""
    from mxnet_tpu_torch import compile as mxc
    from mxnet_tpu_torch.ops import registry as reg

    args, _ = _la_cases(cuda_device, torch.float32)["linalg_syevd"]
    a = args[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError, match="synchronizing"):
            torch.linalg.eigh(a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    f = mxc.jit(lambda t: nd.linalg_syevd(nd.NDArray(t))[1]._data * 2,
                site="card_test", token=("syevd",))
    got = [f(a) for _ in range(3)]
    st = f.stats()
    assert st["captures"] == 0 and st["replays"] == 0
    assert mxc.stats()["card_test"]["uncaptured"].get(
        "host op linalg_syevd", 0) >= 3
    want = 2 * torch.linalg.eigvalsh(a.double())
    torch.testing.assert_close(got[2].double(), want, rtol=1e-4, atol=1e-4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x = a.clone()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(reg.HostOpInCapture, match="linalg_syevd"):
        with torch.cuda.graph(graph):
            reg.get("_linalg_syevd")(x)
    torch.cuda.synchronize()


def _small_ssd():
    """``chip_smoke``'s SSD builders on a narrow backbone: three conv-ReLU
    layers (strides 2, 4, 8), two feature layers from it and one extra,
    at 64 x 64."""
    import chip_smoke as cs

    x = mx.sym.var("data")
    for i, (f, s) in enumerate(((8, 2), (16, 2), (16, 2))):
        x = mx.sym.Convolution(x, kernel=(3, 3), pad=(1, 1), stride=(s, s),
                               num_filter=f, name=f"body{i}")
        x = mx.sym.Activation(x, act_type="relu", name=f"body{i}_relu")
    layers = cs.ssd_multi_layer_feature(
        mx, x, ["body1_relu", "body2_relu", ""], (-1, -1, 32), (-1, -1, 2),
        (-1, -1, 1), min_filter=16)
    sym = cs.ssd_symbol_train(
        mx, layers, 3, ((.2, .3), (.4, .5), (.6, .8)),
        ((1, 2, .5), (1, 2, .5, 3, 1. / 3), (1, 2, .5)), nms_thresh=0.45,
        nms_topk=20)
    return sym, cs.ssd_batch(4, 64, 3, 4, seed=0)


def _bound_ssd(sym, batch, ctx):
    x, y = batch
    ex = sym.simple_bind(ctx, grad_req="write", data=x.shape, label=y.shape)
    rs = np.random.RandomState(1)
    for name, arr in sorted(ex.arg_dict.items()):
        v = x if name == "data" else y if name == "label" else \
            (rs.randn(*arr.shape) * 0.1).astype(np.float32)
        arr._data.copy_(torch.from_numpy(v))
    return ex


def _ssd_step(ex):
    outs = [o._data.clone() for o in ex.forward(is_train=True)]
    ex.backward()
    return outs, {n: g._data.clone() for n, g in ex.grad_dict.items()
                  if n not in ("data", "label")}


@pytest.mark.gpu
def test_ssd_executor_replays_with_no_host_sync_and_equals_eager(
        cuda_device):
    """The SSD training graph (MultiBoxTarget, SoftmaxOutput, smooth-L1,
    MakeLoss, MultiBoxDetection with its NMS) as the executor's captured
    pair: the first call eager, the second captured, the third a replay
    that syncs nothing with the host (``set_sync_debug_mode("error")``)
    and equals the eager step from the same weights (cuDNN's weight
    gradients sum in varying order: rtol 1e-4)."""
    from mxnet_tpu_torch import compile as mxc

    sym, batch = _small_ssd()
    want_outs, want_grads = _eager(
        lambda: _ssd_step(_bound_ssd(sym, batch, mx.gpu(0))))
    ex = _bound_ssd(sym, batch, mx.gpu(0))
    before = dict(mxc.stats().get("executor", {"captures": 0, "replays": 0}))
    for _ in range(2):
        _ssd_step(ex)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs, grads = _ssd_step(ex)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    st = mxc.stats()["executor"]
    assert st["captures"] - before["captures"] == 1
    assert st["replays"] - before["replays"] >= 4
    assert not st["uncaptured"]
    for got, want in zip(outs, want_outs):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    for name, want in want_grads.items():
        torch.testing.assert_close(grads[name], want, rtol=1e-4, atol=1e-6,
                                   msg=name)


@pytest.mark.gpu
def test_nms_and_multibox_target_match_the_cpu_on_ties(cuda_device):
    """At SSD-512's 6132 anchors, with exact duplicates and tied scores:
    NMS keeps the same rows on the card as on the CPU (the stable sort
    keeps the first of equal boxes), and ``MultiBoxTarget`` picks the same
    hard negatives among equal confidences."""
    rs = np.random.RandomState(5)
    n = 6132
    xy = rs.uniform(0, 0.7, (4, n, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(0.05, 0.3, (4, n, 2))], -1)
    boxes[:, 1::2] = boxes[:, ::2]
    scores = np.round(rs.uniform(0, 1, (4, n, 1)), 1)
    ids = rs.randint(0, 5, (4, n, 1))
    det = np.concatenate([ids, scores, boxes], -1).astype(np.float32)
    kw = dict(overlap_thresh=0.45, valid_thresh=0.01, topk=400, id_index=0)
    nms = reg.get("box_nms")
    got = nms(torch.tensor(det, device=cuda_device), **kw).cpu()
    want = nms(torch.tensor(det), **kw)
    assert torch.equal(got, want)
    assert ((want == -1).all(-1)).any() and ((want != -1).all(-1)).any()
    anchors = reg.get("MultiBoxPrior")(torch.zeros(1, 1, 32, 32),
                                       sizes=(.1, .141), ratios=(1, 2, .5))
    anchors = torch.cat([anchors] * 2, 1)[:, :n]
    label = np.full((4, 8, 5), -1, np.float32)
    for i in range(4):
        k = i + 2
        label[i, :k, 0] = rs.randint(0, 20, k)
        xy = rs.uniform(0, 0.5, (k, 2))
        label[i, :k, 1:] = np.concatenate([xy, xy + 0.3], -1)
    pred = np.full((4, 21, n), 0.5, np.float32)
    target = reg.get("MultiBoxTarget")
    args = [anchors, torch.tensor(label), torch.tensor(pred)]
    mkw = dict(negative_mining_ratio=3, negative_mining_thresh=0.5)
    got = target(*[a.to(cuda_device) for a in args], **mkw)
    want = target(*args, **mkw)
    assert torch.equal(got[2].cpu(), want[2])
    assert torch.equal(got[1].cpu(), want[1])
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)
    assert (want[2] == 0).any() and (want[2] == -1).any()


# ---------------------------------------- trainer options and telemetry ---

TELEMETRY_CFG = {"vocab": 500, "units": 64, "hidden": 128, "heads": 4,
                 "layers": 2, "seq_len": 16, "num_classes": 2}


def _small_trainer(ctx, **kw):
    from chip_smoke import build_classifier, random_params
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

    with ctx:
        clf = build_classifier(mx, TELEMETRY_CFG)
        clf.initialize(mx.init.Zero())
        load_jax_params(clf, random_params(TELEMETRY_CFG, seed=0))
        return ShardedTrainer(clf, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              "adam", {"learning_rate": 1e-3},
                              mesh=DeviceMesh({"dp": 1}, devices=[ctx]),
                              **kw)


def _small_task(batch=8):
    from chip_smoke import make_task

    return make_task(batch, TELEMETRY_CFG["seq_len"], TELEMETRY_CFG["vocab"],
                     TELEMETRY_CFG["num_classes"], seed=5)


@pytest.mark.gpu
def test_captured_step_flops_equal_the_cpu_count(cuda_device):
    """The flops counted when the card's step entry is made (its eager
    first call: aten products on this thread and on autograd's engine
    thread, K3, K3-bwd and K2 by their formulas) equal the same step's
    count on the CPU (the plain versions) and the analytic count; each
    replay reports them."""
    from chip_smoke import classifier_step_flops
    from mxnet_tpu_torch.telemetry import costs

    x, y = _small_task()
    got = {}
    for ctx in (mx.gpu(0), mx.cpu()):
        st = _small_trainer(ctx)
        for _ in range(3):
            st.step(x, y)
        got[ctx.device_type] = (costs.flops_for(st._step_fn._token_key),
                                st.step_report()["flops"])
    want = classifier_step_flops(TELEMETRY_CFG, 8)
    assert got["gpu"] == got["cpu"] == (want, want)


@pytest.mark.gpu
def test_warmup_captures_once_and_takes_no_step(cuda_device):
    from mxnet_tpu_torch import compile as C

    x, y = _small_task()
    st = _small_trainer(mx.gpu(0))
    before = [t.clone() for t in st._state_tensors().values()]
    site = dict(C.stats().get("trainer", {"captures": 0, "replays": 0}))
    st.warmup(mx.nd.array(x), mx.nd.array(y))
    torch.cuda.synchronize()
    now = C.stats()["trainer"]
    assert now["captures"] - site.get("captures", 0) == 1
    assert now["replays"] == site.get("replays", 0) and st._t == 0
    assert all(torch.equal(a, b) for a, b in
               zip(before, st._state_tensors().values()))
    st.step(x, y)
    after = C.stats()["trainer"]
    assert (after["captures"], after["replays"]) == \
        (now["captures"], now["replays"] + 1)


@pytest.mark.gpu
def test_memory_gauges_equal_the_allocator_statistics(cuda_device):
    from mxnet_tpu_torch.telemetry import memory, registry

    keep = torch.empty(1 << 20, device=cuda_device)
    torch.cuda.synchronize()
    recs = memory.sample()
    stats = torch.cuda.memory_stats(0)
    rec = recs[0]
    assert rec["device"] == "gpu:0" and rec["source"] == "memory_stats"
    assert rec["live_bytes"] == stats["allocated_bytes.all.current"]
    assert rec["peak_bytes"] == stats["allocated_bytes.all.peak"] == \
        torch.cuda.max_memory_allocated(0)
    live = registry.get("mxtpu_device_memory_live_bytes").series()
    peak = registry.get("mxtpu_device_memory_peak_bytes").series()
    assert live[("gpu:0",)] == rec["live_bytes"]
    assert peak[("gpu:0",)] == rec["peak_bytes"]
    del keep


@pytest.mark.gpu
def test_aot_lower_on_fake_cuda_tensors_launches_nothing(cuda_device):
    from mxnet_tpu_torch import compile as C

    x, y = _small_task()
    st = _small_trainer(mx.gpu(0))
    before = [t.clone() for t in st._state_tensors().values()]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    site = dict(C.stats().get("trainer", {}))
    low = st.aot_lower(((8, 16), "float32"), ((8,), "float32"))
    torch.cuda.synchronize()
    assert kernels.launch_counts() == launches
    assert dict(C.stats().get("trainer", {})) == site
    assert all(torch.equal(a, b) for a, b in
               zip(before, st._state_tensors().values()))
    text = low.as_text()
    assert "cuda:0" in text.splitlines()[0]
    for family in ("opt_adam", "flash_attention", "flash_attention_bwd_dq",
                   "flash_attention_bwd_dkv"):
        assert f"kernel {family}" in text
    st.step(x, y)
    assert st.step_report()["flops"] == low.flops


def _sparse_pair(seed, n, nnz, width, dev, dup=False):
    from mxnet_tpu_torch.ndarray import sparse as sp

    rs = np.random.RandomState(seed)
    idx = rs.choice(n, nnz, replace=dup).astype(np.int64)
    vals = rs.randn(nnz, width).astype(np.float32)
    return tuple(sp.row_sparse_array((vals, idx), shape=(n, width), ctx=c)
                 for c in (mx.gpu(0), mx.cpu()))


@pytest.mark.gpu
def test_sparse_arrays_and_lazy_sgd_on_card_equal_the_cpu(cuda_device):
    from mxnet_tpu_torch.ndarray import sparse as sp

    a, ac = _sparse_pair(0, 5000, 700, 16, cuda_device)
    b, bc = _sparse_pair(1, 5000, 900, 16, cuda_device)
    assert a.context == mx.gpu(0) and a.indices._data.is_cuda
    for got, want in ((sp.sparse_add(a, b), sp.sparse_add(ac, bc)),
                      (a.retain(mx.nd.array(np.arange(0, 5000, 3),
                                            ctx=mx.gpu(0))),
                       ac.retain(mx.nd.array(np.arange(0, 5000, 3),
                                             ctx=mx.cpu())))):
        assert torch.equal(got.indices._data.cpu(), want.indices._data)
        assert torch.equal(got.data._data.cpu(), want.data._data)
    d, dc = _sparse_pair(2, 300, 900, 4, cuda_device, dup=True)
    m, mc = sp.merge_duplicates(d), sp.merge_duplicates(dc)
    assert torch.equal(m.indices._data.cpu(), mc.indices._data)
    assert torch.equal(m.data._data.cpu(), mc.data._data)
    assert torch.equal(m.tostype("default")._data.cpu(),
                       mc.tostype("default")._data)
    dense = np.random.RandomState(3).randn(40, 30).astype(np.float32)
    dense[dense < 0.8] = 0
    c = sp.csr_matrix(dense, ctx=mx.gpu(0))
    assert torch.equal(c.tostype("default")._data.cpu(),
                       torch.from_numpy(dense))
    for cfg in ({"momentum": 0.9, "wd": 0.01},
                {"clip_gradient": 0.5, "rescale_grad": 0.5, "wd": 0.1}):
        ws = []
        for ctx in (mx.gpu(0), mx.cpu()):
            with ctx:
                kv = mx.kv.create("local")
                kv.init("e", mx.nd.array(_rand((5000, 16), 4)))
                kv.set_optimizer(mx.optimizer.create(
                    "sgd", learning_rate=0.3, **cfg))
                for step in range(3):
                    g, gc = _sparse_pair(10 + step, 5000, 800, 16,
                                         cuda_device, dup=step == 1)
                    kv.push("e", [g if ctx == mx.gpu(0) else gc])
                rows = np.arange(0, 5000, 7)
                out = sp.row_sparse_array(
                    (np.zeros((1, 16), np.float32), [0]), shape=(5000, 16))
                kv.row_sparse_pull("e", out=out, row_ids=mx.nd.array(rows))
                full = mx.nd.zeros((5000, 16))
                kv.pull("e", out=full)
                ws.append((out.data._data.cpu(), full._data.cpu()))
        assert torch.equal(ws[0][0], ws[1][0])
        assert torch.equal(ws[0][1], ws[1][1])


@pytest.mark.gpu
def test_libsvm_batches_on_card(cuda_device, tmp_path):
    path = tmp_path / "x.libsvm"
    rs = np.random.RandomState(0)
    with open(path, "w") as f:
        for _ in range(37):
            idx = np.sort(rs.choice(1000, 9, replace=False))
            f.write(f"{rs.randint(2)} " + " ".join(
                f"{i}:{v:.6g}" for i, v in zip(idx, rs.rand(9))) + "\n")
    kw = dict(data_libsvm=str(path), data_shape=(1000,), batch_size=16)
    card = list(mx.io.LibSVMIter(ctx=mx.gpu(0), **kw))
    cpu = list(mx.io.LibSVMIter(ctx=mx.cpu(), **kw))
    assert len(card) == len(cpu) == 3 and card[-1].pad == 11
    for b, bc in zip(card, cpu):
        csr = b.data[0]
        assert csr.stype == "csr" and csr.data._data.is_cuda
        assert csr.indptr._data.is_cuda and b.label[0]._data.is_cuda
        for part in ("data", "indices", "indptr"):
            assert torch.equal(getattr(csr, part)._data.cpu(),
                               getattr(bc.data[0], part)._data)
        assert torch.equal(csr.tostype("default")._data.cpu(),
                           bc.data[0].tostype("default")._data)


@pytest.mark.gpu
def test_row_sparse_gradient_never_reaches_k1(cuda_device):
    from mxnet_tpu_torch.kernels import opt_step
    from mxnet_tpu_torch.ndarray import sparse as sp

    shapes = {"a": (64, 32), "emb": (10000, 8), "b": (1000,)}
    with mx.gpu(0):
        kv = mx.kv.create("local")
        for i, (k, s) in enumerate(shapes.items()):
            kv.init(k, mx.nd.array(_rand(s, i)))
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9, wd=0.01))
        emb0 = kv._store["emb"]._data.clone()
        seen = []
        sgd = opt_step.opt_sgd
        entry = kernels.entry("opt_sgd")
        kernel = entry.kernel

        def watched(weights, grads, *args, **kwargs):
            seen.append([tuple(g.shape) for g in grads])
            return kernel(weights, grads, *args, **kwargs)

        entry.kernel = watched
        try:
            before = sgd.launches
            rows = np.array([5, 77, 9000], np.int64)
            g = sp.row_sparse_array((np.ones((3, 8), np.float32), rows),
                                    shape=(10000, 8))
            for _ in range(2):
                kv.push(list(shapes), [mx.nd.ones((64, 32)), g,
                                       mx.nd.ones((1000,))])
            torch.cuda.synchronize()
            launched = sgd.launches - before
        finally:
            entry.kernel = kernel
    assert seen == [[(64, 32), (1000,)]] * 2 and launched == 2
    assert g._dense_cache is None
    emb = kv._store["emb"]._data
    mom = kv._updater.states["emb"]._data
    keep = torch.ones(10000, dtype=torch.bool, device=emb.device)
    keep[torch.from_numpy(rows).to(emb.device)] = False
    assert torch.equal(emb[keep], emb0[keep])
    assert not mom[keep].any() and mom[~keep].all()


# (N, C, H, W), F, kernel, stride, pad, groups, channels-last codes, path
QCONV_CARD_CASES = [
    ((2, 3, 224, 224), 64, (7, 7), (2, 2), (3, 3), 1, False, "staged"),
    ((4, 64, 56, 56), 64, (3, 3), (1, 1), (1, 1), 1, False, "async"),
    ((4, 256, 56, 56), 64, (1, 1), (1, 1), (0, 0), 1, True, "async"),
    ((4, 64, 28, 28), 64, (3, 3), (2, 2), (1, 1), 2, False, "async"),
    ((2, 32, 14, 14), 32, (3, 3), (1, 1), (1, 1), 32, False, "staged"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", QCONV_CARD_CASES, ids=[
    "stem", "3x3", "1x1_nhwc", "grouped", "depthwise"])
def test_quantized_conv_k4_route_equals_the_plain_route(cuda_device, case):
    shape, f, kernel, stride, pad, g, nhwc, path = case
    rs = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    if nhwc:
        x = x.to(memory_format=torch.channels_last)
    w = torch.from_numpy(rs.randint(-127, 128, (f, shape[1] // g) + kernel)
                         .astype(np.int8))
    scale = torch.from_numpy((rs.rand(f) * 1e-2 + 1e-4).astype(np.float32))
    b = torch.from_numpy(rs.randn(f).astype(np.float32))
    kw = dict(kernel=kernel, stride=stride, pad=pad, num_filter=f,
              num_group=g, min_calib_range=-3.0, max_calib_range=3.5)
    conv = reg.get("_contrib_quantized_conv")
    want = conv(x, w, scale, b, **kw)
    before = kernels.launch_counts()
    got = conv(*(t.to(cuda_device) for t in (x, w, scale, b)), **kw)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["int8_gemm"] - before["int8_gemm"] == g
    assert after[f"int8_gemm.{path}"] - before[f"int8_gemm.{path}"] == g
    assert got.shape == want.shape
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_amp_float16_dense_step_overflow_halves_the_scale(cuda_device):
    from mxnet_tpu_torch import amp

    try:
        amp.init("float16")
        with mx.gpu(0):
            net = mx.gluon.nn.Dense(4, in_units=8)
            net.initialize(mx.init.One())
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": 0.1})
            amp.init_trainer(trainer)
            scales, flags = [], []
            for big in (False, True, False):
                x = mx.nd.ones((2, 8)) * (1e4 if big else 1.0)
                with mx.autograd.record():
                    out = net(x)
                    loss = out.mean()
                    with amp.scale_loss(loss, trainer) as scaled:
                        pass
                scaled.backward()
                assert out.dtype == torch.float16
                flags.append(amp.unscale(trainer))
                scales.append(trainer._amp_loss_scaler.loss_scale)
                if not flags[-1]:
                    trainer.step(1)
                else:
                    for p in net.collect_params().values():
                        p._fresh_grad = False
    finally:
        amp.turn_off()
    assert flags == [False, True, False]
    assert scales == [2.0 ** 16, 2.0 ** 15, 2.0 ** 15]
    assert np.isfinite(net.weight.data().asnumpy()).all()


@pytest.mark.gpu
def test_has_overflow_finds_inf_and_nan_on_the_card(cuda_device):
    """The largest-magnitude pass flags an inf and a NaN in any gradient,
    not a large finite float16 one, and leaves the gradients as they
    are."""
    from mxnet_tpu_torch import amp

    scaler = amp.LossScaler()
    grads = [torch.ones(1000, device=cuda_device),
             torch.full((3, 700), 6e4, dtype=torch.float16,
                        device=cuda_device),
             torch.ones(2, 2, dtype=torch.bfloat16, device=cuda_device)]
    before = [g.clone() for g in grads]
    assert not scaler.has_overflow(grads)
    for g, b in zip(grads, before):
        assert torch.equal(g, b)
    for i, where, bad in ((1, (2, 650), float("inf")), (0, 999, float("nan")),
                          (2, (1, 1), float("-inf")),
                          (1, (0, 0), float("nan"))):
        grads[i][where] = bad
        assert scaler.has_overflow(grads)
        grads[i][where] = before[i][where]
    assert not scaler.has_overflow(grads)


@pytest.mark.gpu
def test_int8_forward_replays_with_no_host_sync(cuda_device):
    """quantize_mnist's CNN quantized on the CPU, bound for inference on
    the card: the executor's forward captures once, a replay makes no
    host sync and equals the eager forward and the CPU's bit for bit
    (every op on the route is exact or correctly rounded)."""
    from chip_smoke import mnist_sym
    from mxnet_tpu_torch.contrib import quantization as q

    rs = np.random.RandomState(0)
    x = rs.rand(64, 1, 28, 28).astype(np.float32)
    shapes = {"conv1_weight": (8, 1, 3, 3), "conv1_bias": (8,),
              "fc1_weight": (64, 1352), "fc1_bias": (64,),
              "fc2_weight": (10, 64), "fc2_bias": (10,)}
    with mx.cpu():
        args = {k: mx.nd.array(rs.randn(*v).astype(np.float32) * 0.1)
                for k, v in shapes.items()}
        y = np.arange(64, dtype=np.float32) % 10
        qsym, qargs, _ = q.quantize_model(
            mnist_sym(mx), args, {}, calib_mode="naive",
            calib_data=mx.io.NDArrayIter(x, y, batch_size=32))
    head = qsym.get_internals()["fc2_output"]
    cpu = head.eval_with({"data": mx.nd.array(x[:32], ctx=mx.cpu()),
                          **qargs}).asnumpy()
    feed = {k: v.as_in_context(mx.gpu(0)) for k, v in qargs.items()}
    exe = head.bind(mx.gpu(0), args={"data": mx.nd.array(
        x[:32], ctx=mx.gpu(0)), **feed}, grad_req="null")
    eager = exe.forward(is_train=False)[0].asnumpy()     # eager, capture
    before = kernels.launch_counts()["int8_gemm"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = exe.forward(is_train=False)[0]
        out = exe.forward(is_train=False)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    st = exe._fwd.stats()
    assert st["captures"] == 1 and st["replays"] == 2
    assert kernels.launch_counts()["int8_gemm"] - before == 2 * 3
    np.testing.assert_array_equal(out.asnumpy(), eager)
    np.testing.assert_array_equal(eager, cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["exact", "ulp", "reduce", "linalg",
                                    "sampler"])
def test_np_cases_on_card_against_the_cpu(cuda_device, family):
    from chip_smoke import (NP_SCHEMA_CASES, np_case_close, np_cases,
                            np_run_case)

    bad = []
    for i, case in enumerate(np_cases() + NP_SCHEMA_CASES):
        if case[3] != family:
            continue
        if family == "sampler":
            mx.random.seed(5)
            card = np_run_case(case, mx.gpu(0), i)
            mx.random.seed(5)
            again = np_run_case(case, mx.gpu(0), i)
            if not all(np.array_equal(a, b) for a, b in zip(card, again)):
                bad.append((case[0], "repeat"))
        else:
            card = np_run_case(case, mx.gpu(0), i)
        host = np_run_case(case, mx.cpu(), i)
        if len(card) != len(host) or not all(
                np_case_close(family, a, b) for a, b in zip(card, host)):
            bad.append(case[0])
    assert not bad, bad


@pytest.mark.gpu
def test_np_mode_step_equals_nd_mode_step(cuda_device):
    """One gluon.Trainer Adam step of the fine-tune classifier (BERT-base
    width, 2 layers, batch 4) fed mx.np arrays equals the same step fed
    mx.nd arrays, loss and weights bit for bit."""
    from chip_smoke import (BERT_BASE, make_task, np_mode_steps,
                            random_params)

    cfg = dict(BERT_BASE, layers=2)
    weights = random_params(cfg, seed=0)
    x, y = make_task(4, cfg["seq_len"], cfg["vocab"], cfg["num_classes"],
                     seed=1)
    got = {}
    for np_mode in (True, False):
        losses, last, clf, _, _ = np_mode_steps(
            mx.gpu(0), cfg, weights, [(x, y)], np_mode, True, 1e-4, 1e-4)
        got[np_mode] = (losses, last["classes"], [
            p.data()._data.cpu() for p in clf.collect_params().values()])
    assert got[True][0] == got[False][0]
    assert got[True][1] == ("ndarray", "ndarray")
    assert got[False][1] == ("NDArray", "NDArray")
    for a, b in zip(got[True][2], got[False][2]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_bounded_step_on_a_side_stream_under_bf16_autocast(cuda_device):
    """A ``ShardedTrainer`` step bounded by the watchdog (``trainer.step``
    under ``action:raise``: the step runs in a waiter thread) called on a
    non-default stream under bfloat16 autocast gives the inline step's
    loss bit for bit; the step's loss function ran in the waiter, under
    autocast; a float32 step gives another loss."""
    import threading

    from chip_smoke import BERT_BASE, _classifier_on, make_task, random_params
    from mxnet_tpu_torch import watchdog
    from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

    cfg = dict(BERT_BASE, layers=2)
    weights = random_params(cfg, seed=0)
    x, y = make_task(4, cfg["seq_len"], cfg["vocab"], cfg["num_classes"],
                     seed=1)
    seen = []

    class Probe(mx.gluon.loss.SoftmaxCrossEntropyLoss):
        def hybrid_forward(self, F, pred, label, *a):
            seen.append((threading.get_ident(),
                         torch.is_autocast_enabled("cuda")))
            return super().hybrid_forward(F, pred, label, *a)

    got = {}
    try:
        for mode in ("inline", "bounded", "float32"):
            watchdog.configure({"trainer.step": 120}
                               if mode == "bounded" else None)
            st = ShardedTrainer(_classifier_on(mx.gpu(0), cfg, weights),
                                Probe(), "adam", {"learning_rate": 1e-4},
                                mesh=DeviceMesh({"dp": 1}))
            side = torch.cuda.Stream()
            del seen[:]
            with torch.cuda.stream(side), torch.autocast(
                    "cuda", dtype=torch.bfloat16, cache_enabled=False,
                    enabled=mode != "float32"):
                loss = st.step(mx.nd.array(x), mx.nd.array(y))
                got[mode] = loss.asnumpy()
            side.synchronize()
            caller = threading.get_ident()
            assert seen and all(ac == (mode != "float32")
                                for _, ac in seen)
            assert all((tid != caller) == (mode == "bounded")
                       for tid, _ in seen)
    finally:
        watchdog.configure(None)
    assert np.array_equal(got["bounded"], got["inline"])
    assert not np.array_equal(got["bounded"], got["float32"])


@pytest.mark.gpu
def test_host_sync_on_a_busy_stream_stalls_at_its_deadline(cuda_device,
                                                           tmp_path):
    """``wait_to_read`` under a 0.05 s ``host.sync`` deadline, behind
    about a second of spinning on the array's stream, raises
    ``StallError`` well before the stream is done; the bundle records the
    card's memory (no capture is open)."""
    import json
    import os
    import threading
    import time

    from mxnet_tpu_torch import watchdog

    a = mx.nd.ones((4,), ctx=mx.gpu(0))
    torch.cuda.synchronize()
    watchdog.configure({"host.sync": 0.05}, crash_dir=str(tmp_path),
                       interval=0.02)
    try:
        torch.cuda._sleep(int(2e9))   # ~1 s of device spinning
        t0 = time.monotonic()
        with pytest.raises(watchdog.StallError) as ei:
            a.wait_to_read()
        elapsed = time.monotonic() - t0
        busy = torch.cuda.current_stream().query() is False
    finally:
        torch.cuda.synchronize()
        for t in threading.enumerate():
            if t.name == "mxtpu-waiter-host.sync":
                t.join(30)
        watchdog.configure(None)
    assert 0.05 <= elapsed < 0.5 and busy
    assert ei.value.point == "host.sync" and ei.value.deadline == 0.05
    with open(os.path.join(ei.value.bundle, "report.json")) as f:
        report = json.load(f)
    assert isinstance(report["memory"], dict)
