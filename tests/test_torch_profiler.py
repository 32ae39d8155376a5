"""The port's profiler (``mxnet_tpu_torch/profiler.py``) and runtime
features (``mxnet_tpu_torch/runtime.py``) against the JAX package's: the
chrome trace's names, categories and phases and the ``dumps()`` table for
the same op sequence, the instrumentation objects, the ``record_*``
tracks, ``pause``/``resume``, the torch device trace of
``profile_device=True``, the events ``telemetry.trace.dump`` takes, and
``Features()``' keys."""
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import profiler as jprofiler
from mxnet_tpu import runtime as jruntime
from mxnet_tpu_torch import profiler, runtime

from _torch_lifecycle import CPU, lifecycle_clean  # noqa: F401


@pytest.fixture(autouse=True)
def _jax_profiler_clean():
    jprofiler.set_state("stop")
    jprofiler.reset()
    yield
    jprofiler.set_state("stop")
    jprofiler.reset()
    jprofiler.set_config(profile_device=False, filename="profile.json")
    profiler.set_config(profile_device=False, filename="profile.json")


def _imperative(pkg, ctx):
    a = pkg.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4),
                     ctx=ctx)
    b = a + a
    c = pkg.nd.dot(b, b.T)
    d = pkg.nd.relu(c - 5)
    return d.sum()


def _session(prof, fn, path):
    prof.set_config(filename=str(path))
    prof.reset()
    prof.set_state("run")
    try:
        fn()
    finally:
        prof.set_state("stop")
    prof.dump()
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _ops(events):
    return [(e["name"], e["cat"], e["ph"]) for e in events
            if e["cat"] in ("operator", "symbolic")]


def test_imperative_events_and_table_match_jax(tmp_path):
    port = _session(profiler, lambda: _imperative(mx, CPU),
                    tmp_path / "port.json")
    jax = _session(jprofiler, lambda: _imperative(jmx, jmx.cpu()),
                   tmp_path / "jax.json")
    assert _ops(port) == _ops(jax) == [
        (n, "operator", "X") for n in ("broadcast_add", "transpose", "dot",
                                       "_minus_scalar", "relu", "sum")]
    for ev in port:
        assert {"name", "cat", "ph", "pid", "tid", "ts", "dur"} <= set(ev)
    table, jtable = profiler.dumps(), jprofiler.dumps()
    assert table.splitlines()[:2] == jtable.splitlines()[:2]

    def rows(text):
        return sorted((ln[:40].strip(), int(ln[40:49]))
                      for ln in text.splitlines()[2:])
    assert rows(table) == [r for r in rows(jtable)
                           if not r[0].startswith("compile")]
    assert profiler.dumps(sort_by="count", ascending=True).splitlines()[2:]


def test_cachedop_events_match_jax(tmp_path):
    def run(pkg, ctx):
        net = pkg.gluon.nn.Dense(2, in_units=4)
        net.initialize(ctx=ctx)
        net.hybridize()
        x = pkg.nd.ones((3, 4), ctx=ctx)
        return lambda: (net(x), net(x))

    port = _session(profiler, run(mx, CPU), tmp_path / "port.json")
    jax = _session(jprofiler, run(jmx, jmx.cpu()), tmp_path / "jax.json")

    def cached(events):
        return [e for e in _ops(events) if e[0] == "CachedOp"]
    assert cached(port) == cached(jax) == [("CachedOp", "symbolic", "X")] * 2
    # the compile service's track: the entry made by the first call
    names = {e["name"] for e in port}
    assert "compile[cachedop]" in names
    assert "compile_cache.service.cachedop.misses" in names


def test_profile_imperative_off_records_no_operator(tmp_path):
    for prof, pkg, ctx in ((profiler, mx, CPU), (jprofiler, jmx, jmx.cpu())):
        prof.set_config(profile_imperative=False)
        try:
            events = _session(prof, lambda: _imperative(pkg, ctx),
                              tmp_path / "x.json")
        finally:
            prof.set_config(profile_imperative=True)
        assert not [e for e in events if e["cat"] == "operator"]
    assert not profiler._REC_IMPERATIVE and not profiler._REC_SYMBOLIC


def _objects(prof):
    d = prof.Domain("dom")
    with d.new_task("task1"):
        pass
    fr = d.new_frame("frame1")
    fr.start()
    fr.stop()
    with prof.Event("ev1"):
        pass
    c = d.new_counter("ctr", 5)
    c += 2
    c -= 1
    d.new_marker("mark").mark()
    prof.record_skip_step(3, 1)
    prof.record_stall("host.sync", 1.25, "/b")
    prof.record_serving("m", 4, 3, 2.0, 7)
    prof.record_compile("trainer", 5.0, "compile", 1, 2)
    prof.record_cache("dispatch", 4, 1)


def _shape(events):
    return [(e["name"], e["cat"], e["ph"],
             sorted(e.get("args", {})) if e["ph"] != "C" else
             e["args"]) for e in events]


def test_instrumentation_objects_and_tracks_match_jax(tmp_path):
    port = _session(profiler, lambda: _objects(profiler),
                    tmp_path / "port.json")
    jax = _session(jprofiler, lambda: _objects(jprofiler),
                   tmp_path / "jax.json")
    got, want = _shape(port), _shape(jax)
    # the stall counter track counts the process's stalls so far
    strip = [i for i, e in enumerate(want) if e[0] == "watchdog.stalls"]
    for i in strip:
        got[i], want[i] = got[i][:3], want[i][:3]
    assert got == want
    assert ("ctr", "counter", "C", {"ctr": 6}) in got


def test_pause_resume_and_state():
    profiler.set_state("run")
    assert profiler.state() == "run" and profiler._REC_IMPERATIVE
    profiler.pause()
    assert profiler.state() == "stop" and not profiler._REC_IMPERATIVE
    _imperative(mx, CPU)
    assert not profiler.trace_info()["events"]
    profiler.resume()
    _imperative(mx, CPU)
    profiler.set_state("stop")
    assert len([e for e in profiler.trace_info()["events"]
                if e["cat"] == "operator"]) == 6
    with pytest.raises(ValueError):
        profiler.set_state("go")
    with pytest.raises(ValueError):
        profiler.set_config(bogus=1)
    profiler.set_config(profile_all=True)
    assert profiler._config["aggregate_stats"]
    profiler.set_config(profile_all=False)


def test_profile_device_writes_a_torch_chrome_trace(tmp_path):
    fname = str(tmp_path / "prof.json")
    profiler.set_config(filename=fname, profile_device=True)
    profiler.set_state("run")
    _imperative(mx, CPU)
    profiler.set_state("stop")
    path = profiler.device_trace_path()
    assert path == os.path.join(fname + ".device", "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names or "aten::matmul" in names
    # a second session writes anew
    profiler.set_state("run")
    profiler.set_state("stop")
    assert os.path.exists(path)


def test_trace_dump_rebases_profiler_events(tmp_path):
    from mxnet_tpu_torch.telemetry import trace

    profiler.set_config(filename=str(tmp_path / "p.json"))
    profiler.set_state("run")
    _imperative(mx, CPU)
    profiler.set_state("stop")
    with open(trace.dump(str(tmp_path / "t.json"))) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "operator"]
    assert [e["name"] for e in ops] == ["broadcast_add", "transpose", "dot",
                                       "_minus_scalar", "relu", "sum"]
    assert all(e["ts"] >= 0 for e in events if e.get("ph") != "M")
    with open(trace.dump(str(tmp_path / "n.json"),
                         include_profiler=False)) as f:
        assert not [e for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "operator"]


def test_runtime_features_keys_match_jax():
    port, jax = runtime.Features(), jruntime.Features()
    assert list(port) == list(jax)
    assert mx.runtime.Features() is port
    for off in ("TPU", "XLA", "PALLAS", "SPMD"):
        assert not port.is_enabled(off)
    assert port.is_enabled("profiler") and port.is_enabled("CPU")
    assert port.is_enabled("CUDA") == torch.cuda.is_available()
    assert port.is_enabled("CUDNN") == (
        torch.cuda.is_available() and torch.backends.cudnn.is_available())
    with pytest.raises(RuntimeError, match="unknown"):
        port.is_enabled("NOPE")
    assert repr(port["CPU"]) == repr(jax["CPU"]) == "✔ CPU"
    assert [f.name for f in runtime.feature_list()] == list(jax)


def test_lazy_names_resolve():
    for name in ("profiler", "runtime", "watchdog", "preempt"):
        assert getattr(mx, name).__name__ == f"mxnet_tpu_torch.{name}"
