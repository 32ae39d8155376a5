"""The dist kvstore's bucket pipeline after the flat 2-bit layout, on the
CPU in one process: the layout (slot offsets, 16-element alignment, zero
padding, residual views), fault C3 (a value written in place after its
push must not reach the sum; the JAX package's store as the reference),
drains (a key pushed twice before its pull), a partial bucket flushed at
``barrier``, and the compressed pipeline's launches per push and pull
call. The 2-bit pipeline runs only across workers; here a one-worker
group runs it with the all-reduce as the identity (``_dispatch_bucket``
replaced), against the JAX package's ``_xla_compress`` /
``_xla_decompress`` closed form. (Two worker processes:
tests/test_torch_dist_flat.py.)"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.kernels import twobit as jtwobit
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kvstore import buckets, kvstore

CPU = mx.cpu()
THR = 0.5


def _nd(a):
    return mx.nd.array(np.asarray(a, np.float32), ctx=CPU)


@pytest.fixture
def forced(monkeypatch):
    """Bucketing forced on in one process, at a cap of ``cap`` bytes."""
    def make(cap=128):
        monkeypatch.setenv("MXNET_TPU_BUCKET_FORCE", "1")
        monkeypatch.setenv("MXNET_TPU_BUCKET_BYTES", str(cap))
    return make


def _compressed_store(shapes, cap, monkeypatch):
    """A one-worker dist_sync store that runs the 2-bit bucket pipeline
    (the all-reduce is the identity), its keys 0.. registered."""
    monkeypatch.setenv("MXNET_TPU_BUCKET_BYTES", str(cap))
    kv = mx.kv.create("dist_sync")
    kv.set_gradient_compression({"type": "2bit", "threshold": THR})
    kv._procs = 2
    kv._dispatch_bucket = lambda flat: kvstore._Reduction(flat, None)
    monkeypatch.setattr(torch.distributed, "barrier", lambda *a, **k: None)
    for i, s in enumerate(shapes):
        kv.init(i, mx.nd.zeros(s, ctx=CPU))
    return kv


class _Closed:
    """The JAX closed form of one worker's compressed store: per key the
    residual, and per pull the decompressed codes of the pushes since."""

    def __init__(self, shapes):
        self.res = [jnp.zeros(s, jnp.float32) for s in shapes]
        self.pending = {}

    def push(self, k, g):
        codes, self.res[k] = jtwobit._xla_compress(jnp.asarray(g),
                                                   self.res[k], THR)
        out = np.asarray(jtwobit._xla_decompress(codes, THR))
        self.pending[k] = self.pending[k] + out if k in self.pending else out

    def pull(self, k):
        return self.pending.pop(k)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _pull(kv, k, shape):
    out = mx.nd.zeros(shape, ctx=CPU)
    kv.pull(k, out=out)
    return out.asnumpy()


# ---- the layout ------------------------------------------------------------

def test_flat_layout_slots_are_aligned_and_the_padding_is_zero():
    shapes = [(3,), (17, 5), (16,), (0,), (300,), (8, 8), (1,), (2, 7)]
    plan = buckets.BucketPlan(400)
    for i, s in enumerate(shapes):
        plan.register(i, s, "float32")
    plan.register("h", (5,), "float16")   # a bucket of its own
    plan.register("after", (4,), "float32")
    lay = buckets.FlatLayout(plan, torch.device("cpu"))
    keys = list(range(len(shapes))) + ["h", "after"]
    assert list(lay.offsets) == keys
    assert not vars(lay).keys() & {"wire", "residual"}   # made at first use
    off = 0
    for k in keys:
        n = plan.info[k]["nelems"]
        assert lay.offsets[k] == off and off % 16 == 0
        off += -(-n // 16) * 16
    assert lay.size == lay.wire.numel() == lay.residual.numel() == off
    assert lay.padding == off - sum(plan.info[k]["nelems"] for k in keys)
    assert lay.padding <= 15 * len(keys)
    # the buckets tile the buffers in registration order
    ranges = [lay.ranges[b["bid"]] for b in plan.buckets]
    assert ranges[0][0] == 0 and ranges[-1][1] == off
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    for b in plan.buckets:
        lo, hi = lay.ranges[b["bid"]]
        assert all(lo <= lay.offsets[k] < hi or
                   plan.info[k]["nelems"] == 0 for k in b["keys"])
    # residual views only for the float32 keys (the multi-tensor compress)
    assert set(lay.residuals) == set(keys) - {"h"} and set(lay.codes) == \
        set(keys)
    f16 = lay.values(torch.float16)
    assert lay.values(torch.float16) is f16 and f16.numel() == off
    for k in keys:
        assert lay.codes[k].numel() == plan.info[k]["nelems"]
        assert lay.slot(k, f16).shape == plan.info[k]["shape"]
        if k != "h":
            assert lay.residuals[k].shape == plan.info[k]["shape"]
        if not plan.info[k]["nelems"]:
            continue            # an empty view has no address
        assert lay.codes[k].data_ptr() == \
            lay.wire.data_ptr() + lay.offsets[k]
        assert lay.slot(k, f16).data_ptr() == \
            f16.data_ptr() + 2 * lay.offsets[k]
        if k != "h":
            assert lay.residuals[k].data_ptr() == \
                lay.residual.data_ptr() + 4 * lay.offsets[k]
        # a slot of a bucket's slice is the same memory
        bid = plan.info[k]["bucket"]
        lo, hi = lay.ranges[bid]
        assert lay.slot(k, f16[lo:hi], lo).data_ptr() == \
            lay.slot(k, f16).data_ptr()
    assert not lay.wire.any() and not lay.residual.any() and not f16.any()


# ---- fault C3 ----------------------------------------------------------

def test_c3_a_pushed_array_written_before_its_bucket_dispatches(forced):
    """The reproduction of fault C3: two (3, 5) keys in one bucket; push
    key 1 as ones, write 9 into it in place, push key 0, pull key 1. The
    port pulls what the JAX package's store pulls: ones."""
    forced(128)
    kv, jkv = mx.kv.create("dist_sync"), jmx.kv.create("dist_sync")
    for store, nd, ctx in ((kv, mx.nd, {"ctx": CPU}), (jkv, jmx.nd, {})):
        for i in range(2):
            store.init(i, nd.zeros((3, 5), **ctx))
    assert kv._pipeline.plan.info[0]["bucket"] == \
        kv._pipeline.plan.info[1]["bucket"]
    g1, j1 = _nd(np.ones((3, 5))), jmx.nd.array(np.ones((3, 5), np.float32))
    kv.push(1, g1)
    jkv.push(1, j1)
    g1._data.fill_(9.0)
    j1[:] = 9.0
    kv.push(0, _nd(np.ones((3, 5))))
    jkv.push(0, jmx.nd.array(np.ones((3, 5), np.float32)))
    out, jout = mx.nd.zeros((3, 5), ctx=CPU), jmx.nd.zeros((3, 5))
    kv.pull(1, out=out)
    jkv.pull(1, out=jout)
    np.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())
    np.testing.assert_array_equal(out.asnumpy(), np.ones((3, 5)))
    assert kv._pipeline.stats["fused"] == 1
    assert kv._pipeline.stats["copies"] == 2


def test_c3_on_the_compressed_pipeline(monkeypatch):
    """The same sequence through the 2-bit pipeline: the codes are made
    at push, so the pull is the decompressed codes of the ones."""
    kv = _compressed_store([(3, 5), (3, 5)], 128, monkeypatch)
    closed = _Closed([(3, 5), (3, 5)])
    g1 = _nd(np.full((3, 5), 0.7))
    kv.push(1, g1)
    closed.push(1, np.full((3, 5), 0.7, np.float32))
    g1._data.fill_(-9.0)
    kv.push(0, _nd(np.ones((3, 5))))
    closed.push(0, np.ones((3, 5), np.float32))
    got = _pull(kv, 1, (3, 5))
    np.testing.assert_array_equal(_bits(got), _bits(closed.pull(1)))
    np.testing.assert_array_equal(got, np.full((3, 5), THR))


# ---- the compressed pipeline -------------------------------------------

SHAPES = [(5, 7), (130,), (3, 4, 5), (1,), (16,), (2, 9)]


@pytest.fixture
def calls(monkeypatch):
    """The twobit families the store dispatches, in order."""
    seen = []
    dispatch = kernels.dispatch

    def spy(family, *args, **kw):
        seen.append(family)
        return dispatch(family, *args, **kw)

    monkeypatch.setattr(kvstore._kernels, "dispatch", spy)
    return seen


@pytest.mark.parametrize("cap", [64, 512, 4 << 20])
def test_one_compress_per_push_call_and_one_decompress_per_pull_call(
        monkeypatch, calls, cap):
    """Three rounds of one push call over every key (backward order) and
    one pull call: bit-identical to the JAX closed form, one
    multi-tensor compress per push call and one decompress per pull call
    (every bucket is in one contiguous run), no per-key K6/K7."""
    kv = _compressed_store(SHAPES, cap, monkeypatch)
    closed = _Closed(SHAPES)
    rs = np.random.RandomState(cap % 89)
    keys = list(range(len(SHAPES)))
    for _ in range(3):
        grads = [(rs.randn(*s) * 0.6).astype(np.float32) for s in SHAPES]
        del calls[:]
        kv.push(keys[::-1], [_nd(grads[k]) for k in keys[::-1]])
        for k in keys[::-1]:
            closed.push(k, grads[k])
        assert calls == ["twobit_compress_multi"]
        outs = [mx.nd.zeros(s, ctx=CPU) for s in SHAPES]
        kv.pull(keys, out=outs)
        assert calls == ["twobit_compress_multi", "twobit_decompress"]
        for k in keys:
            np.testing.assert_array_equal(_bits(outs[k].asnumpy()),
                                          _bits(closed.pull(k)))
            np.testing.assert_array_equal(_bits(kv._residuals[k].numpy()),
                                          _bits(np.asarray(closed.res[k])))
    n_buckets = len(kv._pipeline.plan.buckets)
    assert kv._pipeline.stats["fused"] == 3 * n_buckets
    assert kv._pipeline.stats["bytes"] == 3 * kv._pipeline.flat.wire.numel()
    assert kv._pipeline.stats["copies"] == 0
    # per-key pulls: one decompress per resolved bucket
    kv.push(keys, [_nd(np.ones(s)) for s in SHAPES])
    del calls[:]
    for k in keys:
        _pull(kv, k, SHAPES[k])
    assert calls == ["twobit_decompress"] * n_buckets


def test_a_key_pushed_twice_before_its_pull_drains_its_bucket(
        monkeypatch, calls):
    """The second push of a staged key dispatches and resolves its
    bucket before the compress writes the slot again; the pull returns
    both rounds' sum, as the per-key path does."""
    kv = _compressed_store(SHAPES, 512, monkeypatch)
    closed = _Closed(SHAPES)
    rs = np.random.RandomState(5)
    a, b = ((rs.randn(*SHAPES[2]) * 0.6).astype(np.float32)
            for _ in range(2))
    bid = kv._pipeline.plan.info[2]["bucket"]
    assert len(kv._pipeline.plan.buckets[bid]["keys"]) > 1
    kv.push(2, _nd(a))
    closed.push(2, a)
    assert 2 in kv._pipeline._staged[bid]
    kv.push(2, _nd(b))        # drains round one first
    closed.push(2, b)
    assert kv._pipeline.stats["fused"] == 1
    # the same key twice in one call: two rounds
    kv.push([2, 2], [_nd(b), _nd(a)])
    closed.push(2, b)
    closed.push(2, a)
    got = _pull(kv, 2, SHAPES[2])
    np.testing.assert_array_equal(_bits(got), _bits(closed.pull(2)))
    np.testing.assert_array_equal(_bits(kv._residuals[2].numpy()),
                                  _bits(np.asarray(closed.res[2])))
    assert calls.count("twobit_compress_multi") == 4


def test_a_key_pushed_again_while_its_bucket_is_in_flight(forced):
    """Uncompressed: the bucket dispatched at its last push is resolved
    before a slot of its buffer is written again; the pull returns both
    rounds' sum, like the per-key path (cap 0)."""
    rs = np.random.RandomState(6)
    rounds = [[rs.randn(3, 5).astype(np.float32) for _ in range(2)]
              for _ in range(2)]
    got = []
    for cap in (128, 0):
        forced(cap)
        kv = mx.kv.create("dist_sync")
        for i in range(2):
            kv.init(i, mx.nd.zeros((3, 5), ctx=CPU))
        for r in rounds:
            kv.push([0, 1], [_nd(g) for g in r])
        got.append([_pull(kv, i, (3, 5)) for i in range(2)])
        if cap:
            assert kv._pipeline.stats["fused"] == 2
    for a, b, i in zip(*got, range(2)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, rounds[0][i] + rounds[1][i],
                                   rtol=1e-6)


@pytest.mark.parametrize("compressed", [False, True])
def test_a_partial_bucket_flushed_at_barrier(forced, monkeypatch,
                                             compressed):
    """Two of a bucket's four keys pushed, then ``barrier``: the bucket
    dispatches whole and only the pushed keys take a value; the others
    keep their stored value and later complete rounds are unaffected."""
    shapes = [(4, 2)] * 4           # 32 bytes each: one bucket at 128
    if compressed:
        kv = _compressed_store(shapes, 128, monkeypatch)
    else:
        forced(128)
        kv = mx.kv.create("dist_sync")
        for i, s in enumerate(shapes):
            kv.init(i, _nd(np.full(s, 5.0)))
    closed = _Closed(shapes)
    rs = np.random.RandomState(8)
    g = [(rs.randn(*s) * 0.6).astype(np.float32) for s in shapes]
    kv.push([2, 0], [_nd(g[2]), _nd(g[0])])
    kv.barrier()
    assert kv._pipeline.stats["fused"] == 1 and not kv._pipeline._staged
    assert not kv._pipeline._inflight
    for k in (2, 0):
        closed.push(k, g[k])
        want = closed.pull(k) if compressed else g[k]
        np.testing.assert_array_equal(_pull(kv, k, shapes[k]), want)
    stored = np.zeros if compressed else (lambda s: np.full(s, 5.0))
    for k in (1, 3):
        np.testing.assert_array_equal(_pull(kv, k, shapes[k]),
                                      stored(shapes[k]))
    kv.push([3, 2, 1, 0], [_nd(g[k]) for k in (3, 2, 1, 0)])
    for k in (3, 2, 1, 0):
        closed.push(k, g[k])
    for k in range(4):
        want = closed.pull(k) if compressed else g[k]
        np.testing.assert_array_equal(_pull(kv, k, shapes[k]), want)
    assert kv._pipeline.stats["fused"] == 2


def test_a_key_registered_after_the_first_push_rebuilds_the_layout(
        monkeypatch):
    """The layout covers the keys registered when it is built; a later
    ``init`` builds it again at the next compressed push, with every
    reduction resolved first and the residuals carried over."""
    kv = _compressed_store(SHAPES[:2], 512, monkeypatch)
    closed = _Closed(SHAPES)
    rs = np.random.RandomState(2)
    g = [(rs.randn(*s) * 0.6).astype(np.float32) for s in SHAPES]
    kv.push([1, 0], [_nd(g[1]), _nd(g[0])])
    closed.push(1, g[1])
    closed.push(0, g[0])
    first = kv._pipeline.flat
    kv.init(2, mx.nd.zeros(SHAPES[2], ctx=CPU))
    kv.push([2, 1], [_nd(g[2]), _nd(g[1])])
    closed.push(2, g[2])
    closed.push(1, g[1])
    assert kv._pipeline.flat is not first
    assert kv._residuals[0] is kv._pipeline.flat.residuals[0]
    for k in range(3):
        np.testing.assert_array_equal(_bits(_pull(kv, k, SHAPES[k])),
                                      _bits(closed.pull(k)))
        np.testing.assert_array_equal(_bits(kv._residuals[k].numpy()),
                                      _bits(np.asarray(closed.res[k])))


def test_the_cpu_pipeline_counts_no_launch(monkeypatch):
    kernels.reset_launch_counts()
    kv = _compressed_store(SHAPES, 512, monkeypatch)
    kv.push(list(range(len(SHAPES))), [_nd(np.ones(s)) for s in SHAPES])
    kv.pull(list(range(len(SHAPES))),
            [mx.nd.zeros(s, ctx=CPU) for s in SHAPES])
    assert not any(kernels.launch_counts().values())


# ---- a bucket of another dtype -------------------------------------------

MIXED = [((3, 5), np.float32), ((4, 3), np.float16), ((5,), np.float16),
         ((2, 2), np.float32)]


def _jax_compressed_store(cap, monkeypatch):
    """The JAX package's dist_sync store through the same one-worker
    2-bit bucket pipeline (its fused collective the identity)."""
    monkeypatch.setenv("MXNET_TPU_BUCKET_BYTES", str(cap))
    jkv = jmx.kv.create("dist_sync")
    jkv.set_gradient_compression({"type": "2bit", "threshold": THR})
    jkv._procs = 2
    jkv._dispatch_bucket = lambda raw, mode: raw
    for i, (s, dt) in enumerate(MIXED):
        jkv.init(i, jmx.nd.zeros(s, dtype=dt))
    return jkv


def test_a_float16_bucket_under_compression_matches_the_jax_store(
        monkeypatch, calls):
    """A bucketed float16 key under 2-bit compression is quantized per key
    and scaled back in float16 (its codes ride its bucket's wire slice),
    as in the JAX package's store; the float32 keys of the same call take
    the one multi-tensor launch. Two rounds, pulled values and residuals
    bit for bit against the JAX store under the same sequence and against
    the port's per-key path (cap 0)."""
    rs = np.random.RandomState(11)
    rounds = [[(rs.randn(*s) * 0.6).astype(dt) for s, dt in MIXED]
              for _ in range(2)]
    keys = list(range(len(MIXED)))
    jkv = _jax_compressed_store(64, monkeypatch)
    stores = []
    for cap in (64, 0):
        monkeypatch.setenv("MXNET_TPU_BUCKET_BYTES", str(cap))
        kv = mx.kv.create("dist_sync")
        kv.set_gradient_compression({"type": "2bit", "threshold": THR})
        kv._procs = 2
        kv._dispatch_bucket = lambda flat: kvstore._Reduction(flat, None)
        kv._cross_host_sum = lambda v: mx.nd.NDArray(v._data.clone())
        for i, (s, dt) in enumerate(MIXED):
            kv.init(i, mx.nd.zeros(s, dtype=dt, ctx=CPU))
        stores.append(kv)
    kv, per_key = stores
    assert {b["dtype"] for b in kv._pipeline.plan.buckets} == \
        {"float32", "float16"}
    jprev = [np.zeros(s, dt) for s, dt in MIXED]
    for grads in rounds:
        got, seen = [], []
        for store in (kv, per_key):
            del calls[:]
            store.push(keys[::-1], [mx.nd.array(grads[k], dtype=grads[k].dtype,
                                                ctx=CPU) for k in keys[::-1]])
            outs = [mx.nd.zeros(s, dtype=dt, ctx=CPU) for s, dt in MIXED]
            store.pull(keys, out=outs)
            got.append([o.asnumpy() for o in outs])
            seen.append(sorted(calls))
        # the float32 keys in one launch, each float16 key per key; the
        # float32 buckets 0 and 2 are two runs of the wire (bucket 1, the
        # float16 one, lies between)
        assert seen[0] == sorted(["twobit_compress_multi"] +
                                 ["twobit_compress"] * 2 +
                                 ["twobit_decompress"] * 4)
        assert seen[1] == sorted(["twobit_compress", "twobit_decompress"] * 4)
        jkv.push(keys[::-1], [jmx.nd.array(grads[k], dtype=grads[k].dtype)
                              for k in keys[::-1]])
        jouts = [jmx.nd.zeros(s, dtype=dt) for s, dt in MIXED]
        jkv.pull(keys, out=jouts)
        for k, (s, dt) in enumerate(MIXED):
            # the JAX store's pull adds each round to the stored value;
            # every value is a small multiple of THR, so the difference
            # is exact
            jnow = jouts[k].asnumpy()
            want = jnow - jprev[k]
            jprev[k] = jnow
            for store, g in zip((kv, per_key), got):
                assert g[k].dtype == want.dtype == dt
                np.testing.assert_array_equal(
                    g[k].view(np.uint8), want.view(np.uint8))
                res = store._residuals[k].numpy()
                jres = np.asarray(jkv._residuals[k])
                assert res.dtype == jres.dtype == dt
                np.testing.assert_array_equal(res.view(np.uint8),
                                              jres.view(np.uint8))
