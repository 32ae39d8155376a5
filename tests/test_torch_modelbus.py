"""The port's model bus (mxnet_tpu_torch/modelbus.py) against the JAX
package's (mxnet_tpu/modelbus.py), on the CPU at a small size.

* Record format, both directions: for each encoding (full, int8_rows,
  topk_rows with its base) a record the JAX bus publishes is read and
  decoded by the port bit for bit, and the other way round; with one
  wall clock (the npz entries carry a timestamp) the payload bytes, and
  so the manifests' CRC32, size, census and step, are equal.
* Behaviour on one scenario in both packages, each with its own server,
  watcher and fault schedule: the finite gate, a torn manifest skipped
  once and counted, a CRC-corrupt payload (``modelbus.apply:corrupt``)
  quarantined, a census mismatch rejected, a poisoned update
  (``modelbus.publish:nan``) leaving the served version pinned, and
  rollback re-publishing the last good version: the same versions,
  reject reasons and reject files.
* ``ShardedTrainer.publish_to(every=K)`` in both packages from the same
  weights and batches: the same steps publish, and the decoded records
  agree within tests/test_torch_train.py's tolerance.
* ``ServedModel.swap_params`` against the JAX one from the same weights,
  with no new serving entry, and ValueError on a wrong shape or dtype;
  swaps racing a stream of requests, every response equal to the
  forward at its stamped version.
"""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import faults as jfaults
from mxnet_tpu import modelbus as jbus
from mxnet_tpu import serving as jserving
from mxnet_tpu_torch import compile as mxc
from mxnet_tpu_torch import faults, modelbus, serving
from mxnet_tpu_torch.modelbus import BusWatcher, ModelBus, decode_update

CPU = mx.cpu()
DIM, HIDDEN, CLASSES = 8, 16, 4
# float32 logits of two Dense layers, two frameworks on the CPU
# (tests/test_torch_serving.py's tolerance)
RTOL = ATOL = 1e-4
CLOCK = 1.7e9  # one wall clock for both packages' npz timestamps


def _weights(seed):
    rs = np.random.RandomState(seed)
    return [(rs.randn(HIDDEN, DIM) * 0.5).astype(np.float32),
            (rs.randn(HIDDEN) * 0.1).astype(np.float32),
            (rs.randn(CLASSES, HIDDEN) * 0.5).astype(np.float32),
            (rs.randn(CLASSES) * 0.1).astype(np.float32)]


def _net(pkg, weights):
    """Dense(16, relu) -> Dense(4) of package ``pkg`` holding
    ``weights`` in collect_params order."""
    nn = pkg.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(HIDDEN, activation="relu"), nn.Dense(CLASSES))
    if pkg is mx:
        net.initialize(ctx=CPU)
        net(mx.nd.zeros((2, DIM), ctx=CPU))
    else:
        net.initialize()
        net(jmx.nd.zeros((2, DIM)))
    for p, w in zip(net.collect_params().values(), weights):
        p.set_data(w if pkg is mx else jmx.nd.array(w))
    return net


def _named(net, delta=0.0):
    return [(n, p.data().asnumpy() + delta)
            for n, p in net.collect_params().items()]


@pytest.fixture()
def servers():
    """Every server appended here is drained, and both fault schedules
    are cleared."""
    out = []
    yield out
    for s in out:
        try:
            s.drain(timeout=10.0)
        except Exception:
            pass
    faults.reset()
    jfaults.reset()


def _serve(pkg, net, servers, name="m"):
    srv = pkg.serving
    c = srv.ModelContainer()
    kw = {"ctx": CPU} if pkg is mx else {}
    c.add_block(name, net, example_shape=(DIM,), buckets=(2, 4), **kw)
    server = srv.ModelServer(c, max_wait_ms=1.0).start()
    servers.append(server)
    return server, next(iter(c))


def _records(rs):
    """A float matrix that rides int8_rows (with an all-zero row), a
    small vector that rides full, and an aux vector."""
    w = rs.randn(32, 16).astype(np.float32)
    w[3] = 0.0
    return w, rs.randn(8).astype(np.float32)


def _publish_pair(monkeypatch, tmp_path, encoding):
    """The same records through each package's bus (one clock), as
    ``{"jax": (bus, version), "port": (bus, version)}`` plus the topk
    base."""
    monkeypatch.setattr(time, "time", lambda: CLOCK)
    rs = np.random.RandomState(0)
    w, b = _records(rs)
    out = {}
    for key, mod in (("jax", jbus), ("port", modelbus)):
        bus = mod.ModelBus(tmp_path / key, compress_threshold=64)
        if encoding == "topk_rows":
            table = rs.randn(64, 8).astype(np.float32) if key == "jax" \
                else out["jax"][2]
            bus.publish([("table", table)], step=1, topk={"table": 4})
            new = table.copy()
            new[[3, 17, 40, 63]] += 5.0
            v = bus.publish([("table", new)], step=2, topk={"table": 4})
            out[key] = (bus, v, table)
        else:
            encodings = {"w": encoding, "b": "full"}
            v = bus.publish([("w", w), ("b", b)], step=7,
                            aux=[("mean", b * 2)], encodings=encodings)
            out[key] = (bus, v, None)
    return out


ENCODINGS = ("full", "int8_rows", "topk_rows")


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_bus_records_cross_both_ways_bit_for_bit(monkeypatch, tmp_path,
                                                 encoding):
    pair = _publish_pair(monkeypatch, tmp_path, encoding)
    (jb, jv, base), (pb, pv, _) = pair["jax"], pair["port"]
    assert jv == pv
    # JAX writes, the port reads; the port writes, JAX reads
    for writer, reader_bus, reader_mod in ((jb, ModelBus, modelbus),
                                           (pb, jbus.ModelBus, jbus)):
        rbus = reader_bus(writer.directory)
        manifest, blob = rbus.read(jv)   # size and CRC verified
        assert [e["encoding"] for e in manifest["params"]][0] == encoding
        bases = [base] if encoding == "topk_rows" else None
        got_p, got_a = reader_mod.decode_update(manifest, blob,
                                                base_params=bases)
        want_p, want_a = decode_update(*ModelBus(writer.directory).read(jv),
                                       base_params=bases)
        jwant_p, jwant_a = jbus.decode_update(
            *jbus.ModelBus(writer.directory).read(jv), base_params=bases)
        for got, want, jwant in zip(got_p + got_a, want_p + want_a,
                                    jwant_p + jwant_a):
            assert got.dtype == want.dtype == jwant.dtype
            assert np.array_equal(got, want) and np.array_equal(got, jwant)
    jm, pm = jb.latest(), pb.latest()
    for key in ("version", "step", "crc32", "size", "params", "aux",
                "base_version", "file"):
        assert jm[key] == pm[key], key
    assert open(jb.payload_path(jv), "rb").read() == \
        open(pb.payload_path(pv), "rb").read()


def test_int8_rows_decode_within_half_a_step(tmp_path):
    """As tests/test_modelbus.py: each int8 row within half a
    quantization step of the published row, a zero row exact."""
    bus = ModelBus(tmp_path / "bus", compress_threshold=64)
    w, b = _records(np.random.RandomState(0))
    v = bus.publish([("w", w), ("b", b)], step=7, aux=[("mean", b * 2)])
    (dw, db), (dmean,) = decode_update(*bus.read(v))
    assert [e["encoding"] for e in bus.latest()["params"]] == \
        ["int8_rows", "full"]
    assert np.array_equal(db, b) and np.array_equal(dmean, b * 2)
    assert np.array_equal(dw[3], w[3])
    step = np.abs(w).max(axis=1, keepdims=True) / 127.0
    assert (np.abs(dw - w) <= step * 0.5 + 1e-7).all()


def test_version_names_and_reject_files_match(tmp_path):
    names = {}
    for key, mod in (("jax", jbus), ("port", modelbus)):
        bus = mod.ModelBus(tmp_path / key)
        v = bus.publish([("w", np.ones((2, 2), np.float32))], step=3)
        bus.write_reject(v, "nonfinite", worker="w/1 x", detail="d")
        names[key] = sorted(p.name for p in (tmp_path / key).iterdir())
        assert bus.quarantined() == {v} and bus.next_version() == v + 1
    assert names["jax"] == names["port"] == [
        "reject-v00000001-w_1_x.json", "v00000001.json",
        "v00000001.update"]


# ------------------------------------------------------------ behaviour --

def test_finite_gate_never_publishes_nan(tmp_path):
    bad = np.ones((4, 4), np.float32)
    bad[1, 2] = np.nan
    for key, mod in (("jax", jbus), ("port", modelbus)):
        bus = mod.ModelBus(tmp_path / key)
        before = mod.stats()
        assert bus.publish([("w", bad)], step=1) is None
        assert bus.manifests() == [] and bus.versions() == []
        after = mod.stats()
        assert after["publish_skipped_nonfinite"] == \
            before["publish_skipped_nonfinite"] + 1
        assert after["published"] == before["published"]


def test_torn_manifest_skipped_once_and_counted(tmp_path, monkeypatch):
    for key, mod in (("jax", jbus), ("port", modelbus)):
        warns = []
        monkeypatch.setattr(
            mod._logger, "warning",
            lambda msg, *a, **k: warns.append(msg % a if a else msg))
        bus = mod.ModelBus(tmp_path / key)
        v = bus.publish([("w", np.ones((2, 2), np.float32))], step=1)
        (tmp_path / key / "v00000009.json").write_text("{ torn")
        before = mod.stats()["torn_skips"]
        assert [m["version"] for m in bus.manifests()] == [v]
        assert [m["version"] for m in bus.manifests()] == [v]
        assert bus.torn_skips == 2
        assert mod.stats()["torn_skips"] == before + 2
        assert len([w for w in warns if "torn" in w]) == 1, key


def _scenario(pkg, bus_mod, fault_mod, tmp_path, servers, run):
    """Run ``run(server, model, bus, watcher, net)`` on package ``pkg``'s
    server over the tiny net; returns what it returns."""
    net = _net(pkg, _weights(20))
    server, model = _serve(pkg, net, servers)
    bus = bus_mod.ModelBus(tmp_path / pkg.__name__)
    watcher = bus_mod.BusWatcher(server, bus, worker="t")
    try:
        return run(server, model, bus, watcher, net, fault_mod)
    finally:
        fault_mod.reset()


PACKAGES = ((jmx, jbus, jfaults), (mx, modelbus, faults))


def _both(tmp_path, servers, run):
    out = [_scenario(pkg, bm, fm, tmp_path, servers, run)
           for pkg, bm, fm in PACKAGES]
    assert out[0] == out[1], out
    return out[1]


def test_crc_corruption_quarantined(tmp_path, servers):
    def run(server, model, bus, w, net, fm):
        v = bus.publish(_named(net, delta=0.5), step=1)
        fm.configure("modelbus.apply:corrupt@1", seed=0)
        got = w.poll_once()
        fm.reset()
        rej = [(r["version"], r["reason"], r["worker"])
               for r in bus.rejects()]
        # a quarantined version is never tried again
        return (v, got, dict(w.rejected), sorted(bus.quarantined()),
                model.version, w.applied_version, rej, w.poll_once())

    v, got, rejected, *_ = _both(tmp_path, servers, run)
    assert got is None and rejected == {v: "crc_mismatch"}


def test_census_mismatch_rejected(tmp_path, servers):
    def run(server, model, bus, w, net, fm):
        v = bus.publish([("w", np.ones((3, 3), np.float32))], step=1)
        return v, w.poll_once(), dict(w.rejected), model.version

    v, got, rejected, version = _both(tmp_path, servers, run)
    assert got is None and rejected == {v: "census_mismatch"}
    assert version == 0


def test_poisoned_update_leaves_the_served_version_pinned(tmp_path,
                                                          servers):
    x = np.random.RandomState(3).randn(2, DIM).astype(np.float32)

    def run(server, model, bus, w, net, fm):
        good = bus.publish(_named(net, delta=0.25), step=1)
        applied = w.poll_once()
        y_good = np.asarray(server.predict("m", x, timeout=10.0))
        fm.configure("modelbus.publish:nan@1", seed=0)
        poisoned = bus.publish(_named(net, delta=0.75), step=2)
        fm.reset()
        fut = server.submit("m", x)
        y = np.asarray(fut.result(10.0))
        return (good, applied, poisoned, w.poll_once(), dict(w.rejected),
                sorted(bus.quarantined()), model.version,
                w.applied_version, fut.model_version,
                bool(np.array_equal(y, y_good)))

    good, applied, poisoned, again, rejected, q, version, *rest = _both(
        tmp_path, servers, run)
    assert applied == good and again is None
    assert rejected == {poisoned: "nonfinite"} and q == [poisoned]
    assert version == good and rest == [good, good, True]


def test_rollback_republishes_the_last_good_version(tmp_path, servers):
    def run(server, model, bus, w, net, fm):
        before = bus_of(model).stats()["rollbacks"]
        good = bus.publish(_named(net, delta=0.25), step=1)
        w.poll_once()
        good_vals = [_host(r) for r in model.pinned()[0]]
        fm.configure("modelbus.publish:nan@1", seed=0)
        poisoned = bus.publish(_named(net, delta=0.75), step=2)
        fm.reset()
        w.poll_once()
        rb = bus.auto_rollback(worker="publisher")
        m = bus.latest()
        again = bus.auto_rollback(worker="publisher")   # idempotent
        applied = w.poll_once()
        same = all(np.array_equal(_host(r), g)
                   for r, g in zip(model.pinned()[0], good_vals))
        files = sorted(p.name for p in (tmp_path / pkg_dir(model))
                       .iterdir())
        return (good, poisoned, rb, m["step"], m["meta"], again, applied,
                same, w.stats()["applied_version"], w.stats()["rejected"],
                bus_of(model).stats()["rollbacks"] - before, files)

    def bus_of(model):
        return modelbus if isinstance(model, serving.ServedModel) else jbus

    def pkg_dir(model):
        return mx.__name__ if isinstance(model, serving.ServedModel) \
            else jmx.__name__

    good, poisoned, rb, step, meta, again, applied, same, *rest = _both(
        tmp_path, servers, run)
    assert rb == poisoned + 1 and step == 1
    assert meta == {"rollback_of": poisoned, "source_version": good}
    assert again is None and applied == rb and same
    assert rest[:3] == [rb, {poisoned: "nonfinite"}, 1]


def _host(r):
    return r.detach().numpy() if hasattr(r, "detach") else np.asarray(r)


def test_watcher_stats_keys_match(tmp_path, servers):
    def run(server, model, bus, w, net, fm):
        v = bus.publish(_named(net, delta=0.5), step=9)
        w2 = server.watch_bus(bus, poll=0.01)
        deadline = time.monotonic() + 10
        while model.version != v and time.monotonic() < deadline:
            time.sleep(0.01)
        st = server.stats()
        keys = (sorted(st), sorted(st["model_bus"]),
                st["models"]["m"]["model_version"],
                st["models"]["m"]["weight_swaps"], w2.age_steps(),
                w2.applied_models)
        server.drain(timeout=10.0)
        return keys + (w2._thread is None,)

    top, bus_keys, version, swaps, age, models, stopped = _both(
        tmp_path, servers, run)
    assert version == 1 and swaps == 1 and age == 0 and models == ["m"]
    assert stopped   # drain stops the watcher first


# -------------------------------------------------------------- trainer --

def test_trainer_publishes_every_k_steps_like_jax(tmp_path):
    """From the same weights and batches, both trainers publish at the
    same steps, the records carry collect_params order, and the decoded
    values agree within tests/test_torch_train.py's bound (1e-2 * lr,
    Adam's steps moving each weight by about lr)."""
    from mxnet_tpu.parallel import DeviceMesh as JaxMesh
    from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
    from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

    lr = 0.01
    weights = _weights(27)
    jnet, net = _net(jmx, weights), _net(mx, weights)
    jst = JaxTrainer(jnet, jmx.gluon.loss.L2Loss(), "adam",
                     {"learning_rate": lr}, mesh=JaxMesh())
    st = ShardedTrainer(net, mx.gluon.loss.L2Loss(), "adam",
                        {"learning_rate": lr},
                        mesh=DeviceMesh({"dp": 1}, devices=[CPU]))
    jb = jst.publish_to(tmp_path / "jax", every=2)
    pb = st.publish_to(tmp_path / "port", every=2)
    assert isinstance(pb, ModelBus)
    rs = np.random.RandomState(5)
    for _ in range(4):
        x = rs.randn(16, DIM).astype(np.float32)
        y = rs.randn(16, CLASSES).astype(np.float32)
        jst.step(jmx.nd.array(x), jmx.nd.array(y))
        st.step(mx.nd.array(x, ctx=CPU), mx.nd.array(y, ctx=CPU))
    assert st.published_versions == jst.published_versions == [1, 2]
    assert [m["step"] for m in pb.manifests()] == \
        [m["step"] for m in jb.manifests()] == [2, 4]
    assert [e["name"] for e in pb.latest()["params"]] == \
        list(net.collect_params())
    got, _ = decode_update(*pb.read(2))
    want, _ = jbus.decode_update(*jb.read(2))
    live = [p.data().asnumpy() for p in net.collect_params().values()]
    for g, w, cur in zip(got, want, live):
        np.testing.assert_array_equal(g, cur)    # the current weights
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-2 * lr)


def test_trainer_never_publishes_a_non_finite_update(tmp_path):
    from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

    net = _net(mx, _weights(28))
    st = ShardedTrainer(net, mx.gluon.loss.L2Loss(), "sgd",
                        {"learning_rate": 0.1}, nan_guard=False,
                        mesh=DeviceMesh({"dp": 1}, devices=[CPU]))
    bus = st.publish_to(tmp_path / "bus", every=1)
    x = np.full((4, DIM), np.nan, np.float32)
    y = np.zeros((4, CLASSES), np.float32)
    st.step(mx.nd.array(x, ctx=CPU), mx.nd.array(y, ctx=CPU))
    assert st.published_versions == [] and bus.versions() == []


# ---------------------------------------------------------------- swaps --

def test_swap_params_matches_jax_served_model():
    weights = _weights(23)
    jnet, net = _net(jmx, weights), _net(mx, weights)
    jmodel = jserving.ServedModel.from_block("m", jnet, example_shape=(DIM,),
                                             buckets=(2, 4))
    model = serving.ServedModel.from_block("m", net, example_shape=(DIM,),
                                           buckets=(2, 4), ctx=CPU)
    # the names carry each package's gluon prefixes; shapes and dtypes
    # are the contract
    assert [(e["shape"], e["dtype"]) for e in model.census()["params"]] == \
        [(e["shape"], e["dtype"]) for e in jmodel.census()["params"]]
    assert model.census()["aux"] == jmodel.census()["aux"] == []
    model.warmup()
    misses = mxc.stats()["serving"]["misses"]
    x = np.random.RandomState(3).randn(4, DIM).astype(np.float32)
    y0 = model.run(x)[0]
    new = [w * 1.5 + 0.1 for w in weights]
    jmodel.swap_params(new, 7)
    pinned = model.swap_params(new, 7)
    assert pinned[2] == model.version == 7 and model.swaps == 1
    got, version = model.run_versioned(x)
    want, jversion = jmodel.run_versioned(x)
    assert version == jversion == 7
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert not np.allclose(got[0], y0)
    assert mxc.stats()["serving"]["misses"] == misses
    for bad in ([w[:1] for w in new], [w.astype(np.float64) for w in new],
                new[:2]):
        for m in (model, jmodel):
            with pytest.raises(ValueError, match="swap_params"):
                m.swap_params(bad, 8)
    assert model.version == 7 and model.swaps == 1


def test_swap_params_keeps_the_snapshot_storage():
    net = _net(mx, _weights(24))
    model = serving.ServedModel.from_block("m", net, example_shape=(DIM,),
                                           buckets=(2,), ctx=CPU)
    ptrs = [t.data_ptr() for t in model.pinned()[0]]
    model.swap_params([np.zeros(t.shape, np.float32)
                       for t in model.pinned()[0]], 3)
    assert [t.data_ptr() for t in model.pinned()[0]] == ptrs
    assert all(float(t.abs().sum()) == 0.0 for t in model.pinned()[0])
    out = model.run(np.ones((2, DIM), np.float32))[0]
    assert np.array_equal(out, np.zeros_like(out))


def test_atomic_flip_every_response_matches_its_version(tmp_path, servers):
    """Swaps race three request streams; the weights are zero and the
    last bias is the version, so the output of a batch that read one
    version's values is that version everywhere: a torn flip, or a stamp
    that does not match the values, shows in a response."""
    weights = [np.zeros_like(w) for w in _weights(25)]
    net = _net(mx, weights)
    server, model = _serve(mx, net, servers)
    bus = ModelBus(tmp_path / "bus")
    watcher = BusWatcher(server, bus, worker="t-atomic")
    names = list(net.collect_params())
    stop = threading.Event()
    bad, checked = [], [0]
    x = np.zeros((1, DIM), np.float32)

    def load():
        seen = 0
        while not stop.is_set():
            fut = server.submit("m", x)
            out = np.asarray(fut.result(10.0))
            v = fut.model_version
            if not np.array_equal(out, np.full_like(out, float(v))) \
                    or v < seen:
                bad.append((v, seen, out.tolist()))
            seen = v
            checked[0] += 1

    threads = [threading.Thread(target=load, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    for v in range(1, 9):
        pub = [(n, np.full(w.shape, float(v), np.float32)
                if w.ndim == 1 else np.zeros(w.shape, np.float32))
               for n, w in zip(names, weights)]
        assert bus.publish(pub, step=v) == v
        assert watcher.poll_once() == v
        time.sleep(0.03)
    stop.set()
    for t in threads:
        t.join(timeout=10.0)
    assert not bad, bad[:3]
    assert checked[0] > 0 and model.version == 8 and model.swaps == 8


def test_two_swappers_and_a_replay_never_mix_versions():
    """Two threads swap two value sets (odd versions one set, even the
    other) while a third replays: every batch equals, bit for bit, the
    output of the set its stamped version names."""
    net = _net(mx, _weights(26))
    model = serving.ServedModel.from_block("m", net, example_shape=(DIM,),
                                           buckets=(4,), ctx=CPU)
    x = np.random.RandomState(5).randn(4, DIM).astype(np.float32)
    base = [t.detach().clone().numpy() for t in model.pinned()[0]]
    sets = {1: base, 0: [w * 1.5 + 0.1 for w in base]}
    want = {}
    for v in (1, 2):
        model.swap_params(sets[v % 2], v)
        want[v % 2] = model.run(x)[0]
    assert not np.array_equal(want[0], want[1])
    stop, bad, seen = threading.Event(), [], [0]

    def replays():
        while not stop.is_set():
            out, v = model.run_versioned(x)
            if not np.array_equal(out[0], want[v % 2]):
                bad.append(v)
            seen[0] += 1

    def swaps(first):
        for v in range(first, 83, 2):
            model.swap_params(sets[v % 2], v)

    reader = threading.Thread(target=replays, daemon=True)
    reader.start()
    swappers = [threading.Thread(target=swaps, args=(f,), daemon=True)
                for f in (3, 4)]
    for t in swappers:
        t.start()
    for t in swappers:
        t.join(timeout=60)
    stop.set()
    reader.join(timeout=60)
    assert not bad and seen[0] > 0 and model.swaps == 82
    out, v = model.run_versioned(x)
    assert np.array_equal(out[0], want[v % 2])


def test_int8_model_rejects_a_float32_record(tmp_path, servers):
    """A model whose census holds int8 weights and their scales does not
    match a float32 record: rejected as census_mismatch."""
    sym = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=4,
                                name="fc")
    args = {"fc_weight": mx.nd.array(np.ones((4, DIM), np.int8),
                                     dtype="int8", ctx=CPU),
            "fc_bias": mx.nd.zeros((4,), ctx=CPU)}
    model = serving.ServedModel.from_symbol(
        "q", sym, args, {}, example_shape=(DIM,), buckets=(2,), ctx=CPU)
    assert [e["dtype"] for e in model.census()["params"]] == \
        ["int8", "float32"]
    server = serving.ModelServer(serving.ModelContainer([model])).start()
    servers.append(server)
    bus = ModelBus(tmp_path / "bus")
    v = bus.publish([("fc_weight", np.ones((4, DIM), np.float32)),
                     ("fc_bias", np.zeros(4, np.float32))], step=1)
    w = BusWatcher(server, bus, worker="t-int8")
    assert w.poll_once() is None
    assert w.rejected == {v: "census_mismatch"} and model.version == 0


def test_a_poisoned_int8_row_decodes_non_finite_and_is_rejected(tmp_path,
                                                                 servers):
    """The in-transit poison of a parameter that rides int8_rows. The JAX
    package's encoder gives a row holding NaN the scale 1 and an undefined
    int8 cast, so the record decodes finite and a subscriber applies it
    (reproduced here); the port's keeps a NaN scale for that row, so the
    watcher rejects the record as nonfinite. Finite rows encode alike,
    bit for bit."""
    import warnings

    rs = np.random.RandomState(6)
    w = rs.randn(64, 16).astype(np.float32)
    w[5, 3] = np.nan
    ent = {"name": "w", "shape": [64, 16], "dtype": "float32",
           "encoding": "int8_rows"}
    out, jout = {}, {}
    modelbus._encode_param(w, "int8_rows", "p0", out)
    with warnings.catch_warnings(), np.errstate(invalid="ignore"):
        warnings.simplefilter("ignore", RuntimeWarning)
        jbus._encode_param(w, "int8_rows", "p0", jout)
    got = modelbus._decode_param(ent, out, "p0")
    jgot = jbus._decode_param(ent, jout, "p0")
    assert np.isnan(got[5]).all() and np.isfinite(np.delete(got, 5, 0)).all()
    assert np.isfinite(jgot).all()
    assert np.array_equal(np.delete(out["p0_q"], 5, 0),
                          np.delete(jout["p0_q"], 5, 0))
    assert np.array_equal(np.delete(out["p0_s"], 5),
                          np.delete(jout["p0_s"], 5))
    # end to end: the first parameter rides int8_rows and is poisoned
    net = _net(mx, _weights(29))
    server, model = _serve(mx, net, servers)
    bus = ModelBus(tmp_path / "bus", compress_threshold=64)
    watcher = BusWatcher(server, bus, worker="t-int8-poison")
    faults.configure("modelbus.publish:nan@1", seed=0)
    v = bus.publish(_named(net, delta=0.5), step=1)
    faults.reset()
    assert bus.latest()["params"][0]["encoding"] == "int8_rows"
    assert watcher.poll_once() is None
    assert watcher.rejected == {v: "nonfinite"} and model.version == 0


# ------------------------------------------- faults, flight recorder, log --

FAULT_SPECS = ["p:raise@2", "p:raise@2+", "p:raise@1,3", "p:raise@*",
               "p:raise@p0.5", "p:corrupt@1", "p:nan@2", "p:delay@1:0.001",
               "a:raise@1;p:nan@*"]


def _outcomes(mod, spec, payload):
    mod.configure(spec, seed=3)
    out = []
    for _ in range(6):
        try:
            got = mod.point("p", payload)
            out.append(("ok", got if isinstance(got, bytes)
                        else np.asarray(got).tobytes()))
        except Exception as e:
            out.append((type(e).__name__,))
    stats = mod.stats()
    mod.reset()
    return out, stats


@pytest.mark.parametrize("spec", FAULT_SPECS)
@pytest.mark.parametrize("kind", ["bytes", "array"])
def test_fault_schedules_fire_like_jax(spec, kind):
    """The same schedule and seed fire on the same invocations in both
    packages and corrupt or poison the payload the same way."""
    payload = bytes(range(200)) if kind == "bytes" else \
        np.arange(16, dtype=np.float32).reshape(4, 4)
    assert _outcomes(faults, spec, payload) == \
        _outcomes(jfaults, spec, payload)


def test_fault_grammar_errors_and_peerloss():
    for bad in ("p", "p:explode@1"):
        with pytest.raises(ValueError) as want:
            jfaults.configure(bad)
        with pytest.raises(ValueError) as got:
            faults.configure(bad)
        assert str(got.value) == str(want.value)
    faults.configure({"p": "peerloss@1:1"})
    try:
        with pytest.raises(mx.base.MXNetError, match="not ported"):
            faults.point("p")
    finally:
        faults.reset()
    assert not faults.active() and faults.point("p", 7) == 7


def test_retry_backs_off_like_jax():
    for mod in (faults, jfaults):
        calls = []

        @mod.retry(retries=2, backoff=0.0)
        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise mod.InjectedFault("x")
            return len(calls)

        assert flaky() == 3


def test_flight_recorder_matches_jax():
    from mxnet_tpu.telemetry import flight as jflight
    from mxnet_tpu_torch.telemetry import flight

    for mod in (flight, jflight):
        mod.clear()
        mod.rec("modelbus.publish", "1", "step=10")
        mod.rec("serving.batch", "m", "bucket=2 rows=1")
        mod.rec("modelbus.publish", "2", "step=20")
    got, want = flight.tail(), jflight.tail()
    keys = ("kind", "point", "label")
    assert [{k: e[k] for k in keys} for e in got] == \
        [{k: e[k] for k in keys} for e in want]
    assert flight.counts() == jflight.counts() == {"modelbus.publish": 2,
                                                   "serving.batch": 1}
    assert [e["point"] for e in flight.tail(2)] == ["m", "2"]
    assert flight.size() == jflight.size()
    flight.clear()
    assert flight.tail() == [] and flight.counts() == {}


def test_bus_events_reach_the_flight_recorder(tmp_path):
    from mxnet_tpu_torch.telemetry import flight

    flight.clear()
    bus = ModelBus(tmp_path / "bus")
    bus.publish([("w", np.ones((2, 2), np.float32))], step=4)
    bad = np.full((2, 2), np.nan, np.float32)
    assert bus.publish([("w", bad)], step=5) is None
    kinds = [e["kind"] for e in flight.tail()]
    assert kinds == ["modelbus.publish", "modelbus.skip_nonfinite"]


def test_get_logger_attaches_one_handler(tmp_path):
    from mxnet_tpu_torch import log

    a = log.get_logger("mxtt.test.log", level=log.INFO)
    b = log.get_logger("mxtt.test.log")
    assert a is b and len(a.handlers) == 1 and a.level == log.WARNING
    f = log.get_logger("mxtt.test.file", filename=str(tmp_path / "l.txt"))
    f.warning("hello %s", "bus")
    f.handlers[0].flush()
    assert "WARNING mxtt.test.file: hello bus" in \
        (tmp_path / "l.txt").read_text()


def test_topk_record_applies_on_the_served_base(tmp_path, servers):
    """A sparse (topk_rows) record diffs against the version the watcher
    serves. Published before the watcher applied its base, it is skipped
    (a stale skip, not a reject) and the base applied; the next poll
    applies it on the served values (read back from the model). Both
    packages end on the published values, bit for bit."""
    def run(server, model, bus, w, net, fm):
        named = _named(net)
        first = named[0][0]
        stale0 = bus_stats(model)["stale_skips"]
        bus.publish(named, step=1, topk={first: 4})
        bumped = [(n, a.copy()) for n, a in named]
        bumped[0][1][[1, 5, 9, 14]] += 3.0
        bus.publish(bumped, step=2, topk={first: 4})
        m2 = bus.latest()
        polls = [w.poll_once(), w.poll_once()]
        got = [_host(r) for r in model.pinned()[0]]
        return (polls, m2["base_version"], m2["params"][0]["encoding"],
                bus_stats(model)["stale_skips"] - stale0, dict(w.rejected),
                all(np.array_equal(g, x) for g, (_, x) in zip(got, bumped)))

    def bus_stats(model):
        return (modelbus if isinstance(model, serving.ServedModel)
                else jbus).stats()

    assert _both(tmp_path, servers, run) == (
        [1, 2], 1, "topk_rows", 1, {}, True)
