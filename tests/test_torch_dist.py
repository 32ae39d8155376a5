"""The port's dist_sync kvstore across two worker processes on the CPU
(gloo over a localhost TCP rendezvous, the environment of
tools/launch.py), held against closed forms built from the JAX package's
2-bit functions and optimizer: compressed push and pull for 3 rounds with
bucketing off and at 4 MiB, and two gluon.Trainer steps of a tiny model.
Each worker process has its own timeout of 120 s."""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.kernels import twobit as jtwobit

ROOT = Path(__file__).resolve().parents[1]
WORKERS = 2
THR = 0.5
SHAPES = [(5, 7), (130,), (3, 4, 5), (1,)]
ROUNDS = 3
TRAIN = {"batch": 4, "steps": 2, "threshold": 0.05, "lr": 0.1,
         "momentum": 0.9, "wd": 0.01}


# shared by this module and the workers, which must not import it: the
# JAX package joins MXTPU_COORDINATOR's group when it is imported
_COMMON = textwrap.dedent(f"""
    import numpy as np
    SHAPES, ROUNDS, THR, TRAIN = {SHAPES!r}, {ROUNDS!r}, {THR!r}, {TRAIN!r}


    def _grads(rank, rnd):
        rs = np.random.RandomState(1000 * rank + rnd)
        return [(rs.randn(*s) * 0.6).astype(np.float32) for s in SHAPES]
""")
exec(_COMMON)


_PUSH_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import mxnet_tpu_torch as mx

    out_path = sys.argv[1]
    cpu = mx.cpu()
    kv = mx.kv.create("dist_sync")
    kv.set_gradient_compression({"type": "2bit", "threshold": THR})
    for i, s in enumerate(SHAPES):
        kv.init(i, mx.nd.zeros(s, ctx=cpu))
    result = {"rank": kv.rank, "num_workers": kv.num_workers,
              "buckets": kv._pipeline is not None, "rounds": []}
    for rnd in range(ROUNDS):
        grads = _grads(kv.rank, rnd)
        for i in reversed(range(len(SHAPES))):   # backward order
            kv.push(i, mx.nd.array(grads[i], ctx=cpu))
        pulled = []
        for i, s in enumerate(SHAPES):
            o = mx.nd.zeros(s, ctx=cpu)
            kv.pull(i, out=o)
            pulled.append(o.asnumpy().tolist())
        result["rounds"].append({
            "pulled": pulled,
            "residuals": [kv._residuals[i].numpy().tolist()
                          for i in range(len(SHAPES))]})
    kv.barrier()
    with open(out_path, "w") as f:
        json.dump(result, f)
    print("DIST_OK", kv.rank)
""")

_TRAINER_CHILD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import mxnet_tpu_torch as mx

    out_path = sys.argv[1]
    cpu = mx.cpu()
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(5, in_units=4, activation="relu"))
        net.add(mx.gluon.nn.Dense(3, in_units=5))
    net.initialize(mx.init.Xavier(), ctx=cpu,
                   generator=torch.Generator().manual_seed(0))
    kv = mx.kv.create("dist_sync")
    kv.set_gradient_compression({"type": "2bit",
                                 "threshold": TRAIN["threshold"]})
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": TRAIN["lr"],
                                "momentum": TRAIN["momentum"],
                                "wd": TRAIN["wd"]}, kvstore=kv)
    params = list(net.collect_params().values())
    result = {"initial": [p.data().asnumpy().tolist() for p in params],
              "pushed": []}
    push = kv.push

    def logged_push(key, value, priority=0):
        # the Trainer pushes every key in one call, as lists
        for k, v in zip(key, value) if isinstance(key, list) else \
                [(key, value)]:
            result["pushed"][-1][k] = v.asnumpy().tolist()
        return push(key, value, priority)

    kv.push = logged_push
    rs = np.random.RandomState(kv.rank)
    for _ in range(TRAIN["steps"]):
        x = rs.randn(TRAIN["batch"], 4).astype(np.float32)
        y = rs.randn(TRAIN["batch"], 3).astype(np.float32)
        result["pushed"].append({})
        with mx.autograd.record():
            loss = mx.gluon.loss.L2Loss()(net(mx.nd.array(x, ctx=cpu)),
                                          mx.nd.array(y, ctx=cpu))
        loss.backward()
        trainer.step(TRAIN["batch"] * kv.num_workers)
    result["final"] = [p.data().asnumpy().tolist() for p in params]
    with open(out_path, "w") as f:
        json.dump(result, f)
    print("DIST_OK", kv.rank)
""")


def _run_workers(tmp_path, child_src, extra_env=None, timeout=120):
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
                   os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1", **(extra_env or {}))
        paths.append(tmp_path / f"rank{rank}.json")
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(paths[-1])], env=env,
            cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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


def _closed_form_rounds():
    """Per round: the pulled gradient (the same on every rank) and each
    rank's residuals, from JAX's _xla_compress per rank, the sum of the
    codes and _xla_decompress."""
    res = [[jnp.zeros(s, jnp.float32) for s in SHAPES]
           for _ in range(WORKERS)]
    rounds = []
    for rnd in range(ROUNDS):
        codes = []
        for r in range(WORKERS):
            per = []
            for i, g in enumerate(_grads(r, rnd)):
                c, res[r][i] = jtwobit._xla_compress(jnp.asarray(g),
                                                     res[r][i], THR)
                per.append(c)
            codes.append(per)
        pulled = [np.asarray(jtwobit._xla_decompress(
            sum(codes[r][i] for r in range(WORKERS)), THR))
            for i in range(len(SHAPES))]
        rounds.append({"pulled": pulled,
                       "residuals": [[np.asarray(x) for x in res[r]]
                                     for r in range(WORKERS)]})
    return rounds


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_compressed_push_pull_two_workers_match_the_jax_closed_form(
        tmp_path):
    """3 rounds over 2 ranks, bucketing off (cap 0) and at 4 MiB: every
    pull and residual bit-identical across ranks and caps and to the
    closed form."""
    want = _closed_form_rounds()
    for cap in ("0", str(4 << 20)):
        runs = _run_workers(tmp_path, _PUSH_CHILD,
                            {"MXNET_TPU_BUCKET_BYTES": cap})
        for r, run in enumerate(runs):
            assert (run["rank"], run["num_workers"]) == (r, WORKERS)
            assert run["buckets"] == (cap != "0")
            for rnd, (got, exp) in enumerate(zip(run["rounds"], want)):
                for i in range(len(SHAPES)):
                    np.testing.assert_array_equal(
                        _bits(got["pulled"][i]), _bits(exp["pulled"][i]),
                        err_msg=f"cap {cap} rank {r} round {rnd} key {i}")
                    np.testing.assert_array_equal(
                        _bits(got["residuals"][i]),
                        _bits(exp["residuals"][r][i]))
    # some codes fired, of both signs
    first = want[0]["pulled"][0]
    assert (first > 0).any() and (first < 0).any() and (first == 0).any()


def test_trainer_two_workers_match_the_jax_closed_form(tmp_path):
    """Two gluon.Trainer steps of a tiny model over dist_sync with 2-bit
    compression: both ranks hold identical weights, equal (float32, to
    1e-6) to JAX's compress / sum / decompress of the gradients each rank
    pushed, followed by JAX's SGD-momentum update."""
    runs = _run_workers(tmp_path, _TRAINER_CHILD)
    for a, b in zip(runs[0]["final"], runs[1]["final"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(runs[0]["initial"], runs[1]["initial"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    thr, n_keys = TRAIN["threshold"], len(runs[0]["initial"])
    opt = jmx.optimizer.create("sgd", learning_rate=TRAIN["lr"],
                               momentum=TRAIN["momentum"], wd=TRAIN["wd"])
    opt.rescale_grad = 1.0 / (TRAIN["batch"] * WORKERS)
    weights = [jmx.nd.array(np.asarray(w, np.float32))
               for w in runs[0]["initial"]]
    states = [opt.create_state(i, w) for i, w in enumerate(weights)]
    res = [[jnp.zeros(w.shape, jnp.float32) for w in weights]
           for _ in range(WORKERS)]
    fired = 0
    for step in range(TRAIN["steps"]):
        for i in range(n_keys):
            total = 0
            for r in range(WORKERS):
                g = jnp.asarray(np.asarray(runs[r]["pushed"][step][str(i)],
                                           np.float32))
                codes, res[r][i] = jtwobit._xla_compress(g, res[r][i], thr)
                total = total + codes
                fired += int((np.asarray(codes) != 0).sum())
            opt.update(i, weights[i],
                       jmx.nd.array(jtwobit._xla_decompress(total, thr)),
                       states[i])
    assert fired > 0
    for got, want in zip(runs[0]["final"], weights):
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   want.asnumpy(), rtol=1e-6, atol=1e-7)
    assert not np.allclose(np.asarray(runs[0]["final"][0]),
                           np.asarray(runs[0]["initial"][0]))


def test_workers_without_a_peer_do_not_shrink_to_one(tmp_path):
    """One rank alone at the rendezvous raises instead of running as a
    one-worker group."""
    code = textwrap.dedent("""
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import base
        base.RENDEZVOUS_TIMEOUT_S = 3.0
        try:
            mx.kv.create("dist_sync")
        except mx.MXNetError as e:
            print("RAISED", "could not join" in str(e))
    """)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MXTPU_COORDINATOR=f"127.0.0.1:{port}",
               MXTPU_NUM_WORKERS="2", MXTPU_WORKER_ID="0",
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=120)
    assert "RAISED True" in out.stdout, out.stdout + out.stderr


@pytest.mark.parametrize("name", ["dist_sync", "dist_device_sync",
                                  "dist_sync_device"])
def test_dist_types_form_a_one_worker_group_without_the_environment(
        name, monkeypatch):
    import mxnet_tpu_torch as mx

    monkeypatch.delenv("MXTPU_NUM_WORKERS", raising=False)
    kv = mx.kv.create(name)
    assert (kv.type, kv.rank, kv.num_workers) == (name, 0, 1)
