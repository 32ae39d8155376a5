"""The port's preemption drain (``mxnet_tpu_torch/preempt.py``) against
the JAX package's: the exit ladder, the drain-event record, the signal
handlers (install, a second signal, the ``preempt`` fault mode, the
environment), ``ShardedTrainer.step`` refusing work with
``DrainRequested``, the trainer's final checkpoint and its resume,
``Module.fit``'s drain, ``ModelServer.run_until_drained``, and one real
SIGTERM to a training child process. The last two tests hold the
lifecycle fixture itself: the first leaves every kind of state behind,
the second (run after it on the same worker) finds none.
"""
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu import preempt as jpreempt
from mxnet_tpu import watchdog as jwatchdog
from mxnet_tpu_torch import faults, preempt, profiler, serving, watchdog
from mxnet_tpu_torch.checkpoint import CheckpointManager

from _torch_lifecycle import (CPU, LIFECYCLE_ENV, batch, lifecycle_clean,
                              make_trainer, monitor_threads,
                              params_of)  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ------------------------------------------------------------ exit ladder --

_CODES = [0, 75, 76, 86, 137, -9, -15, 143, 1, 2, 255, None]


def test_exit_ladder_matches_jax():
    assert preempt.EXIT_LADDER == jpreempt.EXIT_LADDER
    assert (preempt.DRAIN_EXIT_CODE, preempt.PEERLOST_EXIT_CODE,
            watchdog.ABORT_EXIT_CODE) == (
        jpreempt.DRAIN_EXIT_CODE, jpreempt.PEERLOST_EXIT_CODE,
        jwatchdog.ABORT_EXIT_CODE) == (75, 76, 86)
    for rc in _CODES:
        assert preempt.canonical_exit(rc) == jpreempt.canonical_exit(rc)
        if rc is not None:
            assert preempt.classify_exit(rc) == jpreempt.classify_exit(rc)
            assert preempt.exit_severity(rc) == jpreempt.exit_severity(rc)
    assert preempt.classify_exit(-9) == "killed"
    assert preempt.classify_exit(3) == "error"


@pytest.mark.parametrize("codes", [[], [0, 75], [75, 0, 76], [86, 137, 0],
                                   [-9, 75], [1, 137], [0, None, 76],
                                   [2, 255, 86]])
def test_most_severe_matches_jax(codes):
    assert preempt.most_severe(codes) == jpreempt.most_severe(codes)


def test_exit_code_env(monkeypatch):
    for val in ("75", "3", "nope"):
        monkeypatch.setenv("MXNET_TPU_PREEMPT_EXIT_CODE", val)
        assert preempt.exit_code() == jpreempt.exit_code()


# -------------------------------------------------------------- handlers --

def test_sigterm_sets_drain_flag_and_uninstall_restores():
    prev = signal.getsignal(signal.SIGTERM)
    assert preempt.install() and preempt.installed()
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(0.05)
    assert preempt.requested()
    ev = preempt.event()
    assert ev["signal"] == "SIGTERM" and ev["pid"] == os.getpid()
    assert preempt.describe()["installed"] == ["SIGINT", "SIGTERM"]
    preempt.uninstall()
    assert not preempt.installed() and not preempt.requested()
    assert signal.getsignal(signal.SIGTERM) is prev


def test_install_off_the_main_thread_returns_false():
    got = []
    t = threading.Thread(target=lambda: got.append(preempt.install()))
    t.start()
    t.join()
    assert got == [False] and not preempt.installed()


def test_second_signal_exits_immediately(monkeypatch):
    codes = []
    monkeypatch.setattr(preempt, "_exit_fn", codes.append)
    preempt.install()
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(0.05)
    assert preempt.requested() and not codes
    os.kill(os.getpid(), signal.SIGTERM)   # the grace is over: exit now
    time.sleep(0.05)
    assert codes == [preempt.DRAIN_EXIT_CODE]


def test_faults_preempt_mode_delivers_sigterm_and_continues():
    preempt.install()
    faults.configure("p:preempt@2")
    faults.point("p")
    assert not preempt.requested()
    out = faults.point("p", "payload")   # SIGTERM to self, then goes on
    time.sleep(0.05)
    assert out == "payload" and preempt.requested()
    assert preempt.event()["signal"] == "SIGTERM"


def test_env_auto_install(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PREEMPT", "sigterm")
    assert preempt.maybe_install_from_env() and preempt.installed()
    assert preempt.describe()["installed"] == ["SIGTERM"]
    preempt.uninstall()
    monkeypatch.setenv("MXNET_TPU_PREEMPT", "0")
    assert not preempt.maybe_install_from_env()
    assert not preempt.installed()
    monkeypatch.setenv("MXNET_TPU_PREEMPT", "sigterm,bogus")
    assert not preempt.maybe_install_from_env()   # warned, not installed
    assert preempt._parse_signals("sigint") == \
        jpreempt._parse_signals("sigint")


# ---------------------------------------------------------- the trainer ---

def test_step_refuses_new_work_once_draining():
    net, tr = make_trainer()
    tr.step(*batch(0))
    before = params_of(net)
    preempt.request("test")
    with pytest.raises(preempt.DrainRequested, match="drain requested"):
        tr.step(*batch(1))
    for k, v in params_of(net).items():   # the refused step changed nothing
        np.testing.assert_array_equal(before[k], v)
    assert tr._t == 1
    preempt.clear()
    tr.step(*batch(1))


def _event_keys(pkg, tmp):
    pkg.clear()
    pkg.request("drill")
    ev = pkg.drain(save=lambda: {"states": "s.params"}, exit=False,
                   directory=str(tmp))
    rec = pkg.last_drain(str(tmp))
    pkg.clear()
    return set(ev), set(rec), rec


def test_drain_event_keys_match_jax(tmp_path):
    port = _event_keys(preempt, tmp_path / "port")
    jax = _event_keys(jpreempt, tmp_path / "jax")
    assert port[0] == jax[0] and port[1] == jax[1]
    rec = port[2]
    assert rec["reason"] == "drill" and rec["exit_code"] == 75
    assert rec["final_checkpoint"] == "written"
    assert rec["checkpoint_files"] == {"states": "s.params"}
    assert rec["flight_tail"] and rec["path"].startswith(str(tmp_path))


def test_drain_writes_final_checkpoint_and_resume_continues(tmp_path):
    net, tr = make_trainer()
    mgr = CheckpointManager(tmp_path, prefix="el")
    it = mx.io.NDArrayIter(np.zeros((40, 6), np.float32), batch_size=8)
    for s in range(4):
        tr.step(*batch(s))
    tr.save_checkpoint(mgr, 1, data_iter=it)
    with CPU:
        it.next()
        it.next()
    preempt.request("drill")
    with pytest.raises(SystemExit) as exc:
        preempt.drain(directory=str(tmp_path))
    assert exc.value.code == preempt.DRAIN_EXIT_CODE == 75
    entry, paths = mgr.load()
    assert entry["epoch"] == 2 and entry["step"] == 4
    assert entry["meta"]["drain"]["reason"] == "drill"
    assert entry["meta"]["data_state"]["cursor"] == 8   # two batches read
    assert mgr.verify(entry)
    ev = preempt.last_drain(str(tmp_path))
    assert ev["final_checkpoint"] == "written" and ev["exit_code"] == 75
    assert set(ev["checkpoint_files"]) == {"states"}
    preempt.clear()
    net2, tr2 = make_trainer(seed=99)
    it2 = mx.io.NDArrayIter(np.zeros((40, 6), np.float32), batch_size=8)
    assert tr2.resume(mgr, data_iter=it2)["step"] == 4 and tr2._t == 4
    assert it2.cursor == 8
    for (ka, va), (kb, vb) in zip(params_of(net).items(),
                                  params_of(net2).items()):
        np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(tr.step(*batch(4)).asnumpy(),
                                  tr2.step(*batch(4)).asnumpy())


def test_drain_without_hook_still_exits_with_code(tmp_path):
    preempt.request("no-hook")
    with pytest.raises(SystemExit) as exc:
        preempt.drain(directory=str(tmp_path))
    assert exc.value.code == 75
    assert preempt.last_drain(
        str(tmp_path))["final_checkpoint"] == "no hook installed"


def test_a_user_hook_is_kept_by_the_trainer(tmp_path):
    def mine():
        return None

    watchdog.set_last_resort(mine)
    net, tr = make_trainer()
    tr.step(*batch(0))
    tr.save_checkpoint(CheckpointManager(tmp_path, prefix="u"), 1)
    assert watchdog.last_resort() is mine


# ------------------------------------------------------ the fit loops -----

def test_module_fit_drains_through_epoch_end_callbacks(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PREEMPT_DIR", str(tmp_path))
    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    sym = mx.sym.SoftmaxOutput(fc, mx.sym.var("softmax_label"),
                               name="softmax")
    rs = np.random.RandomState(0)
    X = rs.randn(64, 5).astype(np.float32)
    Y = rs.randint(0, 3, 64).astype(np.float32)
    saved = []
    with CPU:
        it = mx.io.NDArrayIter(X, Y, batch_size=16,
                               label_name="softmax_label")
        mod = mx.mod.Module(sym, context=CPU)
        preempt.request("module-drill")
        with pytest.raises(SystemExit) as exc:
            mod.fit(it, num_epoch=4,
                    epoch_end_callback=lambda e, s, a, x: saved.append(
                        (e, sorted(a))))
    assert exc.value.code == 75
    assert saved == [(0, ["fc_bias", "fc_weight"])]   # once, mid-epoch 0
    ev = preempt.last_drain(str(tmp_path))
    assert ev["reason"] == "module-drill"
    assert ev["final_checkpoint"] == "skipped"


def test_run_until_drained_answers_admitted_and_refuses_later(tmp_path,
                                                              monkeypatch):
    monkeypatch.setenv("MXNET_TPU_PREEMPT_DIR", str(tmp_path))
    net = mx.gluon.nn.Dense(10, in_units=16)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    c = serving.ModelContainer()
    c.add_block("m", net, example_shape=(16,), buckets=(2,), ctx=CPU)
    srv = serving.ModelServer(c, max_wait_ms=0.5).start()
    try:
        srv.warmup()
        futs = [srv.submit("m", np.zeros((1, 16), np.float32))
                for _ in range(8)]
        preempt.request("test-preemption")
        ev = srv.run_until_drained(install=False, exit=False)
        assert ev["exit_code"] == 75 and ev["reason"] == "test-preemption"
        assert ev["serving"]["drained"] is True
        for f in futs:
            assert f.result(1.0).shape == (1, 10)
        with pytest.raises(serving.ServerDrainingError):
            srv.submit("m", np.zeros((1, 16), np.float32))
        assert any(f.startswith("drain-") for f in os.listdir(tmp_path))
        with pytest.raises(SystemExit) as exc:
            srv.run_until_drained(install=False, exit=True)
        assert exc.value.code == 75
    finally:
        srv.stop()


# ------------------------------------------------ a real SIGTERM, a child --

_CHILD = textwrap.dedent("""
    import os, sys
    sys.path.insert(0, {tests!r})
    sys.path.insert(0, {repo!r})
    import numpy as np
    from mxnet_tpu_torch import preempt
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from _torch_lifecycle import batch, make_trainer

    net, tr = make_trainer()
    mgr = CheckpointManager({ckpt!r}, prefix="c")
    tr.save_checkpoint(mgr, 0)
    print("INSTALLED", preempt.installed(), flush=True)
    step = 0
    while True:
        try:
            loss = tr.step(*batch(step))
        except preempt.DrainRequested:
            preempt.drain()
        print("STEP", tr._t, float(loss.asnumpy()), flush=True)
        step += 1
        if step == 3:
            sys.stdin.readline()   # the parent's SIGTERM comes now
""")


def test_sigterm_to_a_training_child_drains_and_resumes_bit_for_bit(
        tmp_path):
    """A child trains with ``MXNET_TPU_PREEMPT=1`` (installed by the
    trainer) and gets a real SIGTERM after step 3: it finishes that step,
    its next ``step`` raises ``DrainRequested``, ``preempt.drain()``
    writes the trainer's checkpoint and exits 75. Resumed here, the
    trainer goes on with the uninterrupted run's losses bit for bit."""
    ckpt = str(tmp_path / "ckpt")
    env = {k: v for k, v in os.environ.items() if k not in LIFECYCLE_ENV}
    env.update(MXNET_TPU_PREEMPT="1",
               MXNET_TPU_PREEMPT_DIR=str(tmp_path / "drain"))
    code = _CHILD.format(tests=os.path.join(REPO, "tests"), repo=REPO,
                         ckpt=ckpt)
    p = subprocess.Popen([sys.executable, "-c", code], env=env,
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        lines = [p.stdout.readline().split() for _ in range(4)]
        p.send_signal(signal.SIGTERM)
        p.stdin.write("\n")
        p.stdin.flush()
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 75, err[-2000:]
    assert lines[0] == ["INSTALLED", "True"]
    child = [float(w[2]) for w in lines[1:]]
    mgr = CheckpointManager(ckpt, prefix="c")
    entry, _ = mgr.load()
    assert entry["epoch"] == 1 and entry["step"] == 3
    assert entry["meta"]["drain"]["signal"] == "SIGTERM"
    ev = preempt.last_drain(str(tmp_path / "drain"))
    assert ev["signal"] == "SIGTERM" and ev["final_checkpoint"] == "written"
    # the uninterrupted run, and the resumed one
    net, tr = make_trainer()
    ref = [float(tr.step(*batch(s)).asnumpy()) for s in range(6)]
    net2, tr2 = make_trainer(seed=99)
    tr2.resume(mgr)
    resumed = [float(tr2.step(*batch(s)).asnumpy()) for s in range(3, 6)]
    assert child + resumed == ref


def test_the_drain_hook_does_not_keep_a_dropped_trainer_alive(tmp_path):
    import gc
    import weakref

    net, tr = make_trainer()
    tr.step(*batch(0))
    tr.save_checkpoint(CheckpointManager(tmp_path, prefix="w"), 1)
    hook, alive = watchdog.last_resort(), weakref.ref(tr)
    assert hook is not None
    del net, tr
    gc.collect()
    assert alive() is None and hook() is None


# ------------------------------------------------ the fixture's own test --

def test_leaky_drill_leaves_state_for_the_fixture(tmp_path):
    """Leaves handlers, a drain request, a last-resort hook, a fault
    schedule, a watchdog monitor of its own, a running profiler and an
    environment variable behind; the autouse fixture removes them."""
    os.environ["MXNET_TPU_PREEMPT"] = "1"
    os.environ["MXNET_TPU_CRASH_DIR"] = str(tmp_path)
    assert preempt.maybe_install_from_env()
    preempt.request("leak")
    watchdog.set_last_resort(lambda: None)
    faults.configure("host.sync:delay@1:0.01")
    watchdog.configure({"host.sync": 30}, interval=0.05)
    profiler.set_config(filename=str(tmp_path / "p.json"))
    profiler.set_state("run")
    mx.nd.ones((2,), ctx=CPU).wait_to_read()
    assert monitor_threads() and faults.ARMED


def test_fixture_left_nothing_behind():
    """Run after the drill above on the same worker: none of its state
    is left."""
    end = time.monotonic() + 2.0
    while len(monitor_threads()) > 1 and time.monotonic() < end:
        time.sleep(0.02)   # a retired monitor returns at its next wake
    assert not preempt.installed() and not preempt.requested()
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, None) or \
        signal.getsignal(signal.SIGTERM) is not preempt._handler
    assert watchdog.last_resort() is None
    assert not faults.ARMED and faults.stats() == {}
    assert profiler.state() == "stop" and not profiler.trace_info()[
        "events"]
    assert os.environ.get("MXNET_TPU_PREEMPT") is None
    assert os.environ.get("MXNET_TPU_CRASH_DIR") is None
    ambient = os.environ.get("MXNET_TPU_WATCHDOG", "")
    assert watchdog.describe().get("spec", "") == ambient
    assert len(monitor_threads()) == (1 if ambient else 0)
