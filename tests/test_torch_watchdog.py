"""The port's watchdog (``mxnet_tpu_torch/watchdog.py``) against the JAX
package's: the ``MXNET_TPU_WATCHDOG`` grammar, the escalation ladder
(warning, crash bundle, StallError or the abort's last resort), hangs at
``host.sync``, ``io.fetch``, ``trainer.step``, ``kvstore.sync`` and
``serving.batch``, heartbeats, ``observe`` mode, and the caller's
thread-local state carried into a bounded step's waiter thread.

Deadlines are 0.3 s and injected hangs 1.2 s: only the watchdog can end
the wait inside the deadline, and an abandoned waiter is joined before
the test ends.
"""
import json
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu import watchdog as jwatchdog
from mxnet_tpu_torch import autograd, faults, profiler, watchdog

from _torch_lifecycle import (CPU, batch, join_waiters, lifecycle_clean,
                              make_trainer)  # noqa: F401

HANG = 1.2
DEADLINE = 0.3


def _configure(tmp_path, point, deadline=DEADLINE, **opts):
    watchdog.configure({point: deadline}, crash_dir=str(tmp_path),
                       interval=0.05, **opts)


def _check_bundle(path, point):
    """A bundle holds every thread's traceback, the last beats and the
    report of the stalled span."""
    assert path and os.path.isdir(path)
    names = set(os.listdir(path))
    assert {"threads.txt", "heartbeats.json", "report.json",
            "flight.json"} <= names
    tb = open(os.path.join(path, "threads.txt")).read()
    assert "Thread" in tb and "File" in tb
    beats = json.load(open(os.path.join(path, "heartbeats.json")))
    assert beats and all({"t_mono", "point", "thread"} <= set(b)
                         for b in beats)
    assert any(b["point"] == point for b in beats)
    rep = json.load(open(os.path.join(path, "report.json")))
    assert rep["point"] == point
    assert rep["deadline_s"] == pytest.approx(DEADLINE)
    assert rep["elapsed_s"] >= DEADLINE
    assert "faults" in rep and "memory" in rep
    assert any(s["point"] == point for s in rep["active_spans"])
    return rep


# ------------------------------------------------------------- grammar ----

_GOOD = ["trainer.step:120,io.fetch:30;*:600,action:abort,warn:0.25,"
         "interval:2,dir:/tmp/x,beats:64",
         "*:540,action:observe,interval:60",
         "trainer.step:5,action:raise",
         "host.sync:0.25; serving.batch:1.5 ,warn:0.9"]
_BAD = ["trainer.step", "action:bogus", "x:,", "action:raise", "",
        "warn:0.5", "beats:abc,*:1", "host.sync:soon"]
_FIELDS = ("deadlines", "default", "action", "warn_fraction", "interval",
           "crash_dir", "beats", "spec")


@pytest.mark.parametrize("spec", _GOOD)
def test_grammar_matches_jax(spec):
    got, want = watchdog._parse(spec), jwatchdog._parse(spec)
    for f in _FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    for point in ("trainer.step", "io.fetch", "host.sync", "other"):
        assert got.deadline_for(point) == want.deadline_for(point)


@pytest.mark.parametrize("spec", _BAD)
def test_grammar_rejects_as_jax(spec):
    with pytest.raises(ValueError):
        jwatchdog._parse(spec)
    with pytest.raises(ValueError):
        watchdog._parse(spec)


def test_configure_dict_and_options(tmp_path):
    watchdog.configure({"host.sync": 9}, action="observe",
                       crash_dir=str(tmp_path))
    d = watchdog.describe()
    assert d["enabled"] and d["deadlines"] == {"host.sync": 9.0}
    assert d["action"] == "observe" and d["crash_dir"] == str(tmp_path)
    watchdog.configure(None)
    assert watchdog.describe() == {"enabled": False}
    with pytest.raises(TypeError):
        watchdog.configure({"host.sync": 1}, bogus=1)


def test_disabled_sync_is_transparent():
    watchdog.configure(None)
    assert watchdog.sync("host.sync", lambda: 41) == 41
    with pytest.raises(KeyError):
        watchdog.sync("host.sync", lambda: {}["missing"])
    assert not watchdog.enabled()


# ------------------------------------------------------ the hang points ---

def test_hang_host_sync_detected(tmp_path):
    _configure(tmp_path, "host.sync")
    faults.configure(f"host.sync:hang@1:{HANG}")
    a = mx.nd.ones((2, 2), ctx=CPU)
    t0 = time.monotonic()
    with pytest.raises(watchdog.StallError) as ei:
        a.wait_to_read()
    elapsed = time.monotonic() - t0
    assert DEADLINE <= elapsed < HANG
    err = ei.value
    assert err.point == "host.sync" and err.deadline == DEADLINE
    _check_bundle(err.bundle, "host.sync")
    assert watchdog.latest_bundle(str(tmp_path)) == err.bundle
    join_waiters("host.sync")


def test_hang_io_fetch_detected_sticky_until_reset(tmp_path):
    _configure(tmp_path, "io.fetch")
    faults.configure(f"io.fetch:hang@1:{HANG}")
    base = mx.io.NDArrayIter(np.arange(48, dtype=np.float32).reshape(12, 4),
                             np.arange(12, dtype=np.float32), batch_size=4)
    it = mx.io.PrefetchingIter(base)
    t0 = time.monotonic()
    with mx.cpu(), pytest.raises(watchdog.StallError) as ei:
        it.next()
    assert time.monotonic() - t0 < HANG
    _check_bundle(ei.value.bundle, "io.fetch")
    with mx.cpu(), pytest.raises(watchdog.StallError):
        it.next()   # sticky: the staged state is torn
    time.sleep(HANG)  # the wedged worker ends before its source resets
    with mx.cpu():
        it.reset()
        assert it.next().data[0].shape == (4, 4)
    assert {"io.fetch"} <= {b["point"] for b in watchdog.heartbeats()}
    join_waiters("io.fetch")


def test_hang_trainer_step_detected_then_training_continues(tmp_path):
    net, tr = make_trainer(optimizer="sgd")
    tr.step(*batch(0))
    _configure(tmp_path, "trainer.step")
    faults.configure(f"trainer.step:hang@1:{HANG}")
    t0 = time.monotonic()
    with pytest.raises(watchdog.StallError) as ei:
        tr.step(*batch(1))
    assert time.monotonic() - t0 < HANG
    rep = _check_bundle(ei.value.bundle, "trainer.step")
    assert rep["label"] == "step 2"
    faults.reset()
    watchdog.configure(None)
    join_waiters("trainer.step")   # the abandoned step ends on its own
    loss = tr.step(*batch(2))
    assert np.isfinite(loss.asnumpy()).all()


def test_kvstore_barrier_raises_peer_lost_with_bundle(tmp_path):
    from mxnet_tpu_torch.kvstore import PeerLostError

    with mx.cpu():
        kv = mx.kv.create("dist_sync")   # a group of this process alone
        kv.init("w", mx.nd.zeros((3,)))
        _configure(tmp_path, "kvstore.sync")
        faults.configure(f"kvstore.sync:hang@1:{HANG}")
        with pytest.raises(PeerLostError, match="peer lost") as ei:
            kv.barrier()
    e = ei.value
    assert isinstance(e, watchdog.StallError)
    assert e.op == "barrier" and e.rank == 0 and e.num_workers == 1
    assert e.exit_code == 76
    _check_bundle(e.bundle, "kvstore.sync")
    join_waiters("kvstore.sync")


def test_serving_batch_stall_fails_typed_and_server_keeps_serving(tmp_path):
    from mxnet_tpu_torch.serving import RequestError

    net = mx.gluon.nn.Dense(4, in_units=6)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    cont = mx.serving.ModelContainer()
    cont.add_block("st", net, example_shape=(6,), buckets=(2,), ctx=CPU)
    srv = mx.serving.ModelServer(cont, max_wait_ms=1.0).start()
    try:
        srv.warmup()
        _configure(tmp_path, "serving.batch")
        faults.configure(f"serving.batch:hang@1:{HANG}")
        x = np.ones((1, 6), np.float32)
        with pytest.raises(RequestError) as ei:
            srv.predict("st", x, timeout=10.0)
        assert isinstance(ei.value.__cause__ or ei.value.cause,
                          watchdog.StallError)
        y = srv.predict("st", x, timeout=10.0)
        want = net(mx.nd.array(x, ctx=CPU)).asnumpy()
        # the bucket pads the row to 2: another GEMM shape, another
        # float32 summation order than the block's call on 1 row
        np.testing.assert_allclose(np.asarray(y.asnumpy()
                                              if hasattr(y, "asnumpy")
                                              else y), want, rtol=1e-5,
                                   atol=1e-6)
        m = srv.stats()["models"]["st"]
        assert m["stalled_batches"] == 1 and m["completed"] == 1
    finally:
        srv.drain(timeout=10.0)
        srv.stop()
        join_waiters("serving.batch")


# ----------------------------------------------------- escalation ladder ---

def test_injected_fault_propagates_through_bounded_sync(tmp_path):
    _configure(tmp_path, "host.sync")
    faults.configure("host.sync:raise@1")
    a = mx.nd.ones((2,), ctx=CPU)
    with pytest.raises(faults.InjectedFault):
        a.wait_to_read()
    a.wait_to_read()   # the schedule is spent


def test_observe_mode_bundles_without_raising(tmp_path):
    _configure(tmp_path, "host.sync", action="observe")
    faults.configure(f"host.sync:delay@1:{DEADLINE * 2.5}")
    a = mx.nd.ones((2,), ctx=CPU)
    caller = threading.get_ident()
    seen = []
    watchdog.sync("host.sync", lambda: seen.append(threading.get_ident()))
    a.wait_to_read()   # blocks past the deadline, completes normally
    assert seen == [caller]   # observe runs the work inline
    bundle = watchdog.latest_bundle(str(tmp_path))
    assert bundle is not None
    assert json.load(open(os.path.join(bundle, "report.json")))[
        "point"] == "host.sync"


def test_warning_fires_before_stall(tmp_path, caplog):
    _configure(tmp_path, "host.sync")
    faults.configure(f"host.sync:hang@1:{HANG}")
    a = mx.nd.ones((2,), ctx=CPU)
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu.watchdog"):
        with pytest.raises(watchdog.StallError):
            a.wait_to_read()
    msgs = [r.getMessage() for r in caplog.records]
    warn = [i for i, m in enumerate(msgs) if "has been blocking" in m]
    stall = [i for i, m in enumerate(msgs) if "crash bundle written" in m]
    assert warn and stall and warn[0] < stall[0], msgs
    join_waiters("host.sync")


def test_abort_action_runs_last_resort_through_exit_seam(tmp_path,
                                                         monkeypatch):
    exits, saved = [], []
    monkeypatch.setattr(watchdog, "_exit_fn", exits.append)
    watchdog.set_last_resort(lambda: saved.append(True))
    _configure(tmp_path, "host.sync", action="abort")
    faults.configure(f"host.sync:hang@1:{HANG}")
    # the seam returns, so the sync falls through to StallError; in a
    # real run os._exit(86) never returns
    with pytest.raises(watchdog.StallError):
        mx.nd.ones((2,), ctx=CPU).wait_to_read()
    assert saved == [True] and exits == [watchdog.ABORT_EXIT_CODE] == [86]
    assert watchdog.latest_bundle(str(tmp_path)) is not None
    join_waiters("host.sync")


def test_heartbeats_recorded_with_labels(tmp_path):
    _configure(tmp_path, "host.sync", deadline=30)
    with mx.cpu():
        mx.nd.waitall()
        kv = mx.kv.create("local")
        kv.init("w", mx.nd.ones((3,)))
        kv.push("w", mx.nd.ones((3,)))
        out = mx.nd.zeros((3,))
        kv.pull("w", out=out)
    beats = watchdog.heartbeats()
    points = {b["point"] for b in beats}
    assert {"host.sync", "kvstore.push", "kvstore.pull"} <= points
    labels = {b["label"] for b in beats if b["point"] == "host.sync"}
    assert "begin waitall" in labels and "end waitall" in labels
    assert all(b["t_mono"] <= time.monotonic() for b in beats)


def test_profiler_counts_stalls(tmp_path):
    profiler.set_config(filename=str(tmp_path / "prof.json"))
    profiler.set_state("run")
    before = profiler.stall_count()
    try:
        _configure(tmp_path, "host.sync")
        faults.configure(f"host.sync:hang@1:{HANG}")
        with pytest.raises(watchdog.StallError):
            mx.nd.ones((2,), ctx=CPU).wait_to_read()
    finally:
        profiler.set_state("stop")
    profiler.dump()
    trace = json.load(open(str(tmp_path / "prof.json")))
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"watchdog.stall", "watchdog.stalls"} <= names
    assert profiler.stall_count() == before + 1
    from mxnet_tpu_torch.telemetry import export

    text = export.render_prometheus()
    assert "mxtpu_watchdog_stalls_total" in text
    assert "mxtpu_watchdog_enabled 1" in text
    join_waiters("host.sync")


# ------------------------------------------------- the caller's state ------

def _state():
    from mxnet_tpu_torch import attribute, context, name, util

    return {"grad": torch.is_grad_enabled(),
            "autocast": torch.is_autocast_enabled("cpu"),
            "autocast_dtype": torch.get_autocast_dtype("cpu"),
            "recording": autograd.is_recording(),
            "training": autograd.is_training(),
            "context": context.current_context(),
            "np_array": util.is_np_array(), "np_shape": util.is_np_shape(),
            "attr": attribute.current().get(),
            "name": id(name.current()),
            "thread": threading.get_ident()}


def test_bounded_sync_carries_the_callers_thread_state(tmp_path):
    _configure(tmp_path, "host.sync", deadline=30)
    with mx.cpu(), mx.AttrScope(group="g1"), mx.name.NameManager(), \
            mx.util.np_array(True), mx.util.np_shape(True), \
            autograd.record(train_mode=False), torch.no_grad(), \
            torch.autocast("cpu", dtype=torch.bfloat16):
        inline = _state()
        bounded = watchdog.sync("host.sync", _state)
    assert bounded.pop("thread") != inline.pop("thread")
    assert bounded == inline
    assert inline["context"] == CPU and inline["np_array"] \
        and inline["recording"] and not inline["grad"] \
        and inline["autocast"] and inline["attr"] == {"__group__": "g1"}
    # the waiter's copy of a stack is its own
    assert getattr(mx.Context._tls, "stack", []) == []


def test_bounded_step_equals_inline_under_np_mode_and_cpu(tmp_path):
    from mxnet_tpu_torch import npx

    losses = {}
    for mode in ("inline", "bounded"):
        if mode == "bounded":
            _configure(tmp_path, "trainer.step", deadline=30)
        else:
            watchdog.configure(None)
        net, tr = make_trainer()
        npx.set_np()
        try:
            with mx.cpu():
                out = [tr.step(*(b.as_np_ndarray() for b in batch(s)))
                       for s in range(4)]
        finally:
            npx.reset_np()
        # np mode reached the step's thread: the loss is an mx.np array
        assert all(type(o) is mx.np.ndarray for o in out)
        losses[mode] = [o.asnumpy() for o in out]
    for a, b in zip(losses["inline"], losses["bounded"]):
        np.testing.assert_array_equal(a, b)
    assert any(b["point"] == "trainer.step" and b["label"] == "begin step 4"
               for b in watchdog.heartbeats())


def test_every_thread_local_of_the_port_is_carried():
    """Each ``threading.local()`` of the port (module or class level) is
    in ``watchdog._CARRIED``, so a bounded point's waiter sees it; the
    data plane's per-thread decode RNG (``io/io.py``'s ``_RNG_TLS``) is
    the worker threads' own."""
    import re

    root = os.path.dirname(os.path.abspath(mx.__file__))
    found = set()
    for dirpath, _, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py") or fname == "watchdog.py":
                continue
            path = os.path.join(dirpath, fname)
            mod = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
            mod = mod[:-len(".__init__")] if mod.endswith(".__init__") \
                else mod
            cls = None
            for line in open(path):
                m = re.match(r"class (\w+)", line)
                if m:
                    cls = m.group(1)
                m = re.match(r"(\s*)(\w+) = (?:threading|_threading)"
                             r"\.local\(\)", line)
                if m:
                    attr = m.group(2) if not m.group(1) else \
                        f"{cls}.{m.group(2)}"
                    found.add((mod, attr))
    assert found - {("io.io", "_RNG_TLS")} == set(watchdog._CARRIED)
