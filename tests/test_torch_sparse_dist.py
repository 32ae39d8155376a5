"""The port's dist stores with row-sparse pushes and ``dist_async``, two
worker processes on the CPU (gloo over a localhost TCP rendezvous, the
environment of tools/launch.py), against closed forms from the JAX
package in this process:

* ``dist_sync``: row-sparse pushes summed across the workers (row union),
  pulled dense and by rows, equal to JAX ``sparse_add`` of both workers'
  arrays; with SGD on the store, the lazy update of the sum equal to JAX
  ``SGD._sparse_update``;
* ``dist_async``: a sign updater gives -2 (two updates), not -1 (one on
  the sum), as JAX tests/test_sparse_dist.py:226-250, by key and through
  the buckets; a row-sparse push is one lazy update per worker;
* ``Module`` on a small MLP under ``dist_async`` for 2 batches, with the
  buckets off and on: both workers' weights bit-identical, and equal to
  rank 0's then rank 1's SGD-momentum updates made with JAX's
  ``sgd_mom_update`` in one process, one ``update_multi`` per worker's
  contribution.

Each worker process has its own timeout of 120 s."""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ndarray import sparse as jsp

ROOT = Path(__file__).resolve().parents[1]
WORKERS = 2
SHAPE = (40, 3)
MLP = {"batch": 6, "in": 5, "hidden": 8, "classes": 3, "batches": 2,
       "lr": 0.1, "momentum": 0.9, "wd": 0.01}

_COMMON = textwrap.dedent(f"""
    import numpy as np
    SHAPE, MLP = {SHAPE!r}, {MLP!r}


    def _rows(rank, rnd):
        rs = np.random.RandomState(100 * rank + rnd)
        idx = np.sort(rs.choice(SHAPE[0], 6 + 3 * rank, replace=False))
        return rs.randn(len(idx), SHAPE[1]).astype(np.float32), idx


    def _batch(rank, t):
        rs = np.random.RandomState(1000 + 10 * rank + t)
        x = rs.randn(MLP["batch"], MLP["in"]).astype(np.float32)
        y = rs.randint(0, MLP["classes"], MLP["batch"]).astype(np.float32)
        return x, y
""")
exec(_COMMON)

_SPARSE_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray.sparse import row_sparse_array

    out_path = sys.argv[1]
    res = {}
    with mx.cpu():
        # dist_sync: the sum of both workers' rows
        kv = mx.kv.create("dist_sync")
        res["num_workers"] = kv.num_workers
        kv.init("e", mx.nd.zeros(SHAPE))
        vals, idx = _rows(kv.rank, 0)
        g = row_sparse_array((vals, idx), shape=SHAPE)
        kv.push("e", g)
        res["lazy"] = g._dense_cache is None
        out = mx.nd.zeros(SHAPE)
        kv.pull("e", out=out)
        res["sync_sum"] = out.asnumpy().tolist()
        rows = row_sparse_array((np.zeros((3, SHAPE[1]), np.float32),
                                 [0, 1, 2]), shape=SHAPE)
        kv.row_sparse_pull("e", out=rows, row_ids=mx.nd.array([1, 5, 9]))
        res["sync_rows"] = [rows.indices.asnumpy().tolist(),
                            rows.data.asnumpy().tolist()]
        res["sparse_stats"] = dict(kv.sparse_stats)
        # dist_sync with SGD on the store: the lazy update of the sum
        kv2 = mx.kv.create("dist_sync")
        kv2.init("w", mx.nd.ones(SHAPE))
        kv2.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5,
                                              momentum=0.9, wd=0.1))
        for rnd in range(2):
            kv2.push("w", row_sparse_array(_rows(kv2.rank, rnd + 1),
                                           shape=SHAPE))
        w = mx.nd.zeros(SHAPE)
        kv2.pull("w", out=w)
        res["sync_sgd"] = w.asnumpy().tolist()
        # dist_async with SGD: one lazy update per worker's rows
        kv3 = mx.kv.create("dist_async")
        kv3.init("w", mx.nd.ones(SHAPE))
        kv3.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5,
                                              momentum=0.9, wd=0.1))
        kv3.push("w", row_sparse_array(_rows(kv3.rank, 3), shape=SHAPE))
        kv3.pull("w", out=w)
        res["async_sgd"] = w.asnumpy().tolist()
        # dist_async's per-push updates, by key and through the buckets
        for cap_key in ("legacy", "bucket"):
            kv4 = mx.kv.create("dist_async")
            if cap_key == "legacy":
                kv4._pipeline = None
            kv4.init("s", mx.nd.zeros((3,)))

            def updater(idx, grad, weight):
                weight[:] = weight - mx.nd.sign(grad)

            kv4._updater = updater
            kv4.push("s", mx.nd.array([float(kv4.rank + 1)] * 3))
            o = mx.nd.zeros((3,))
            kv4.pull("s", out=o)
            res["sign_" + cap_key] = o.asnumpy().tolist()
            res["gathers_" + cap_key] = kv4.gather_stats["gathers"]
        # dist_async without an optimizer sums, as dist_sync
        kv5 = mx.kv.create("dist_async")
        kv5.init("s", mx.nd.zeros((2,)))
        kv5.push("s", mx.nd.array([1.0, float(kv5.rank)]))
        o = mx.nd.zeros((2,))
        kv5.pull("s", out=o)
        res["async_sum"] = o.asnumpy().tolist()
        kv5.barrier()
    with open(out_path, "w") as f:
        json.dump(res, f)
    print("DIST_OK", kv.rank)
""")

_MODULE_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx

    out_path = sys.argv[1]
    with mx.cpu():
        data = mx.sym.var("data")
        h = mx.sym.FullyConnected(data, num_hidden=MLP["hidden"], name="fc1")
        h = mx.sym.Activation(h, act_type="relu", name="relu1")
        h = mx.sym.FullyConnected(h, num_hidden=MLP["classes"], name="fc2")
        net = mx.sym.SoftmaxOutput(h, mx.sym.var("softmax_label"),
                                   name="softmax")
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.bind(data_shapes=[("data", (MLP["batch"], MLP["in"]))],
                 label_shapes=[("softmax_label", (MLP["batch"],))])
        rs = np.random.RandomState(0)   # one initial state on both ranks
        arg = {n: mx.nd.array(rs.randn(*a.shape).astype(np.float32) * 0.3)
               for n, a in mod._exec.arg_dict.items()
               if n not in ("data", "softmax_label")}
        mod.init_params(arg_params=arg, aux_params={})
        kv = mx.kv.create("dist_async")
        if sys.argv[2] == "0":
            kv._pipeline = None
        mod.init_optimizer(kvstore=kv, optimizer="sgd", optimizer_params={
            "learning_rate": MLP["lr"], "momentum": MLP["momentum"],
            "wd": MLP["wd"]})
        upd = kv._updater
        calls = []
        multi = upd.update_multi

        def counted(indices, grads, weights):
            calls[-1] += 1
            return multi(indices, grads, weights)

        upd.update_multi = counted
        res = {"rank": kv.rank, "names": mod._param_names,
               "rescale_grad": mod._optimizer.rescale_grad,
               "initial": {n: a.asnumpy().tolist() for n, a in arg.items()},
               "grads": [], "weights": []}
        for t in range(MLP["batches"]):
            x, y = _batch(kv.rank, t)
            batch = mx.io.DataBatch(data=[mx.nd.array(x)],
                                    label=[mx.nd.array(y)])
            mod.forward_backward(batch)
            res["grads"].append({n: mod._exec.grad_dict[n].asnumpy().tolist()
                                 for n in mod._param_names})
            calls.append(0)
            mod.update()
            res["weights"].append({n: mod._exec.arg_dict[n].asnumpy()
                                   .tolist() for n in mod._param_names})
        res["update_multi_calls"] = calls
    with open(out_path, "w") as f:
        json.dump(res, f)
    print("DIST_OK", kv.rank)
""")


def _run_workers(tmp_path, child_src, args=(), timeout=120):
    """Both ranks of a two-worker group, each with its own timeout; a
    rank that fails or hangs fails the test (the others are killed)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "child.py"
    script.write_text(_COMMON + child_src)
    procs, paths = [], []
    for rank in range(WORKERS):
        env = dict(os.environ, MXTPU_COORDINATOR=f"127.0.0.1:{port}",
                   MXTPU_NUM_WORKERS=str(WORKERS), MXTPU_WORKER_ID=str(rank),
                   PYTHONPATH=str(ROOT) + os.pathsep +
                   os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
        paths.append(tmp_path / f"rank{rank}.json")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(paths[-1]), *args], env=env,
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"DIST_OK {rank}" in out, \
            f"rank {rank} exit {p.returncode}:\n{out[-2000:]}"
    return [json.loads(path.read_text()) for path in paths]


def _jrs(vals, idx):
    return jsp.row_sparse_array((vals, idx), shape=SHAPE)


def _sgd_rows(grads_by_round):
    """JAX's lazy SGD on ones, one update per listed gradient."""
    opt = jmx.optimizer.create("sgd", learning_rate=0.5, momentum=0.9,
                               wd=0.1)
    w = jmx.nd.ones(SHAPE)
    st = opt.create_state(0, w)
    for g in grads_by_round:
        opt.update(0, w, g, st)
    return w.asnumpy()


def test_row_sparse_pushes_and_dist_async_two_workers(tmp_path):
    runs = _run_workers(tmp_path, _SPARSE_CHILD)
    total = jsp.sparse_add(_jrs(*_rows(0, 0)), _jrs(*_rows(1, 0)))
    dense = total.tostype("default").asnumpy()
    for run in runs:
        assert run["num_workers"] == WORKERS and run["lazy"]
        np.testing.assert_array_equal(np.asarray(run["sync_sum"],
                                                 np.float32), dense)
        assert run["sync_rows"][0] == [1, 5, 9]
        np.testing.assert_array_equal(
            np.asarray(run["sync_rows"][1], np.float32), dense[[1, 5, 9]])
        # the rows went over the wire, padded to the larger worker's 9
        assert run["sparse_stats"] == {
            "pushes": 1, "rows": 9,
            "bytes": WORKERS * 9 * (8 + 4 * SHAPE[1])}
        sums = [jsp.sparse_add(_jrs(*_rows(0, r + 1)), _jrs(*_rows(1, r + 1)))
                for r in range(2)]
        np.testing.assert_allclose(np.asarray(run["sync_sgd"], np.float32),
                                   _sgd_rows(sums), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            np.asarray(run["async_sgd"], np.float32),
            _sgd_rows([_jrs(*_rows(0, 3)), _jrs(*_rows(1, 3))]),
            rtol=1e-6, atol=1e-7)
        assert run["sign_legacy"] == [-2.0] * 3
        assert run["sign_bucket"] == [-2.0] * 3
        assert run["gathers_legacy"] == run["gathers_bucket"] == 1
        assert run["async_sum"] == [2.0, 1.0]
    for key in ("sync_sgd", "async_sgd"):
        assert runs[0][key] == runs[1][key]


@pytest.mark.parametrize("buckets", ["0", "1"])
def test_module_under_dist_async_matches_jax_rank_order_updates(tmp_path,
                                                                buckets):
    runs = _run_workers(tmp_path, _MODULE_CHILD, args=(buckets,))
    names = runs[0]["names"]
    for t in range(MLP["batches"]):
        for n in names:
            assert runs[0]["weights"][t][n] == runs[1]["weights"][t][n]
    for run in runs:
        # not scaled by the worker count: only _sync stores are
        assert run["rescale_grad"] == 1.0 / MLP["batch"]
        assert run["update_multi_calls"] == [WORKERS] * MLP["batches"]
    weights = {n: jmx.nd.array(np.asarray(runs[0]["initial"][n], np.float32))
               for n in names}
    moms = {n: jmx.nd.zeros(weights[n].shape) for n in names}
    for t in range(MLP["batches"]):
        for r in range(WORKERS):
            for n in names:
                g = jmx.nd.array(np.asarray(runs[r]["grads"][t][n],
                                            np.float32))
                wd = MLP["wd"] if n.endswith("_weight") else 0.0
                w, m = jmx.nd.sgd_mom_update(
                    weights[n], g, moms[n], lr=MLP["lr"], wd=wd,
                    momentum=MLP["momentum"],
                    rescale_grad=1.0 / MLP["batch"])
                weights[n], moms[n] = w, m
        for n in names:
            np.testing.assert_allclose(
                np.asarray(runs[0]["weights"][t][n], np.float32),
                weights[n].asnumpy(), rtol=1e-6, atol=1e-7,
                err_msg=f"batch {t} {n}")
