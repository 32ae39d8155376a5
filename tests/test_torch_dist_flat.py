"""The 2-bit bucket pipeline across two worker processes on the CPU (gloo
over a localhost TCP rendezvous), held bit for bit against a closed form
built from the JAX package's ``_xla_compress`` / ``_xla_decompress``: the
reproduction of fault C3 under compression (a pushed gradient written in
place before its bucket dispatches), a key pushed twice before its pull
(its bucket drained first), a partial bucket flushed at ``barrier``, and
push and pull calls over lists of keys (one compress and one decompress
per call). Each worker process has its own timeout of 120 s."""
import textwrap

import jax.numpy as jnp
import numpy as np

from mxnet_tpu.kernels import twobit as jtwobit
from test_torch_dist import WORKERS, _run_workers

THR = 0.5
SHAPES = [(5, 7), (130,), (3, 4, 5), (1,), (16,), (2, 9)]
SMALL = [(4, 2)] * 4     # 32 bytes each: one bucket at a 128-byte cap


def _g(rank, tag, shape):
    """The gradient a rank pushes under ``tag`` (a seeded function of
    both; the workers compute the same)."""
    seed = (1000 * rank + sum(map(ord, tag))) % (2 ** 31)
    return (np.random.RandomState(seed).randn(*shape) * 0.6).astype(
        np.float32)


_CHILD = textwrap.dedent('''
    import json, os, sys
    import numpy as np
    import mxnet_tpu_torch as mx

    THR = %(thr)r
    SHAPES, SMALL = %(shapes)r, %(small)r
    cpu = mx.cpu()


    def _g(rank, tag, shape):
        seed = (1000 * rank + sum(map(ord, tag))) %% (2 ** 31)
        return (np.random.RandomState(seed).randn(*shape) * 0.6).astype(
            np.float32)


    def store(cap, shapes):
        os.environ["MXNET_TPU_BUCKET_BYTES"] = str(cap)
        kv = mx.kv.create("dist_sync")
        kv.set_gradient_compression({"type": "2bit", "threshold": THR})
        for i, s in enumerate(shapes):
            kv.init(i, mx.nd.zeros(s, ctx=cpu))
        return kv


    def nd(a):
        return mx.nd.array(a, ctx=cpu)


    def pull(kv, k, shape):
        o = mx.nd.zeros(shape, ctx=cpu)
        kv.pull(k, out=o)
        return o.asnumpy().tolist()


    out = {}
    kv = store(128, [(3, 5), (3, 5)])
    r = kv.rank
    g1 = nd(_g(r, "c3-1", (3, 5)))
    kv.push(1, g1)
    g1._data.fill_(9.0)
    kv.push(0, nd(_g(r, "c3-0", (3, 5))))
    out["c3"] = [pull(kv, k, (3, 5)) for k in (1, 0)]

    kv = store(512, SHAPES)
    kv.push(2, nd(_g(r, "a", SHAPES[2])))
    kv.push(2, nd(_g(r, "b", SHAPES[2])))
    kv.push([2, 2], [nd(_g(r, "b", SHAPES[2])), nd(_g(r, "a", SHAPES[2]))])
    out["twice"] = pull(kv, 2, SHAPES[2])
    out["twice_residual"] = kv._residuals[2].numpy().tolist()

    kv = store(128, SMALL)
    kv.push([2, 0], [nd(_g(r, "p%%d" %% k, SMALL[k])) for k in (2, 0)])
    kv.barrier()
    out["partial_fused"] = kv._pipeline.stats["fused"]
    out["partial"] = [pull(kv, k, SMALL[k]) for k in range(4)]
    kv.push([3, 2, 1, 0], [nd(_g(r, "q%%d" %% k, SMALL[k]))
                           for k in (3, 2, 1, 0)])
    out["complete"] = [pull(kv, k, SMALL[k]) for k in range(4)]

    kv = store(64, SHAPES)
    keys = list(range(len(SHAPES)))
    out["lists"] = []
    for rnd in range(2):
        kv.push(keys[::-1], [nd(_g(r, "l%%d-%%d" %% (rnd, k), SHAPES[k]))
                             for k in keys[::-1]])
        outs = [mx.nd.zeros(s, ctx=cpu) for s in SHAPES]
        kv.pull(keys, out=outs)
        out["lists"].append([o.asnumpy().tolist() for o in outs])
    out["lists_stats"] = dict(kv._pipeline.stats)
    out["lists_wire"] = kv._pipeline.flat.wire.numel()
    out["lists_buckets"] = len(kv._pipeline.plan.buckets)
    kv.barrier()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    print("DIST_OK", kv.rank)
''') % {"thr": THR, "shapes": SHAPES, "small": SMALL}


class _Closed:
    """Per worker a residual per key; a round's pull is the decompressed
    sum of every worker's codes."""

    def __init__(self, shapes):
        self.res = [[jnp.zeros(s, jnp.float32) for s in shapes]
                    for _ in range(WORKERS)]

    def round(self, k, grads):
        total = 0
        for r, g in enumerate(grads):
            codes, self.res[r][k] = jtwobit._xla_compress(
                jnp.asarray(g), self.res[r][k], THR)
            total = total + codes.astype(jnp.int32)
        return np.asarray(jtwobit._xla_decompress(total.astype(jnp.int8),
                                                  THR))


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _eq(got, want, what):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def test_the_compressed_bucket_pipeline_two_workers_matches_the_closed_form(
        tmp_path):
    runs = _run_workers(tmp_path, _CHILD)
    for rank, run in enumerate(runs):
        # fault C3: the codes of key 1 were made at its push
        c = _Closed([(3, 5), (3, 5)])
        want1 = c.round(1, [_g(r, "c3-1", (3, 5)) for r in range(WORKERS)])
        want0 = c.round(0, [_g(r, "c3-0", (3, 5)) for r in range(WORKERS)])
        _eq(run["c3"][0], want1, f"rank {rank} C3 key 1")
        _eq(run["c3"][1], want0, f"rank {rank} C3 key 0")
        assert not np.allclose(run["c3"][0], 9 * THR)
        # a key pushed twice, then twice in one call: four rounds summed
        c = _Closed(SHAPES)
        want = 0
        for tag in ("a", "b", "b", "a"):
            want = want + c.round(2, [_g(r, tag, SHAPES[2])
                                      for r in range(WORKERS)])
        _eq(run["twice"], want, f"rank {rank} key pushed twice")
        _eq(run["twice_residual"], c.res[rank][2], f"rank {rank} residual")
        # a partial bucket flushed at barrier: only the pushed keys change
        c = _Closed(SMALL)
        assert run["partial_fused"] == 1
        for k in range(4):
            want = (c.round(k, [_g(r, f"p{k}", SMALL[k])
                                for r in range(WORKERS)])
                    if k in (2, 0) else np.zeros(SMALL[k], np.float32))
            _eq(run["partial"][k], want, f"rank {rank} partial key {k}")
        for k in range(4):
            _eq(run["complete"][k], c.round(k, [_g(r, f"q{k}", SMALL[k])
                                                for r in range(WORKERS)]),
                f"rank {rank} complete key {k}")
        # push and pull calls over lists, buckets at 64 bytes
        c = _Closed(SHAPES)
        for rnd, got in enumerate(run["lists"]):
            for k in range(len(SHAPES)):
                _eq(got[k], c.round(k, [_g(r, f"l{rnd}-{k}", SHAPES[k])
                                        for r in range(WORKERS)]),
                    f"rank {rank} round {rnd} key {k}")
        stats = run["lists_stats"]
        assert stats["fused"] == 2 * run["lists_buckets"]
        assert stats["bytes"] == 2 * run["lists_wire"]
        assert stats["copies"] == 0
        assert run["lists_wire"] - sum(int(np.prod(s)) for s in SHAPES) <= \
            15 * len(SHAPES)
    for key in ("c3", "twice", "partial", "complete", "lists"):
        assert runs[0][key] == runs[1][key]
