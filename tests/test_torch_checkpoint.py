"""Checkpoints on the CPU: the port's ``checkpoint`` module and
``ShardedTrainer.save_states`` / ``load_states`` / ``save_checkpoint`` /
``resume`` against the JAX package's.

* ``atomic_write``, the CRC manifest, keep-N rotation and the fallback
  from a corrupt newest file to the previous good one;
* a ``MANIFEST.json`` written by either package read by the other;
* trainer state across packages: a JAX file (bfloat16 weights, float32
  running statistics, float32 masters and momenta, ``__t__``, a
  ``MultiFactorScheduler``) loads into the port bit for bit, and the
  port's file (without a scheduler: the JAX unpickler would import the
  port's scheduler class) loads into the JAX trainer bit for bit. The
  sample stream does not cross: the port writes its generator's state
  under ``__rng_key__`` and restores only the seed from a JAX threefry
  key; the JAX trainer steps on after ``mx.random.seed``;
* ``resume`` bit for bit against an uninterrupted run, the state right
  after it equal to the saved one, the lr sequence the same;
* a process that imports only the port reads a JAX checkpoint with a
  scheduler.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu.parallel import DeviceMesh as JaxMesh
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu_torch import checkpoint as ckpt
from mxnet_tpu_torch import lr_scheduler as sched
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

CPU = mx.cpu()
HYPER = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
         "multi_precision": True}


# ---- the module --------------------------------------------------------------

def test_atomic_write_lands_whole_or_not_at_all(tmp_path):
    path = tmp_path / "f.bin"
    crc, size = ckpt.atomic_write(path, lambda t: Path(t).write_bytes(b"ab"))
    assert path.read_bytes() == b"ab" and size == 2
    assert crc == ckpt.crc32_file(path) == jckpt.crc32_file(path)

    def torn(tmp):
        Path(tmp).write_bytes(b"partial")
        raise OSError("killed mid-write")

    with pytest.raises(OSError, match="killed"):
        ckpt.atomic_write(path, torn)
    assert path.read_bytes() == b"ab"
    assert sorted(os.listdir(tmp_path)) == ["f.bin"]


def _save(manager, epoch):
    return manager.save(epoch, {"states": f"epoch {epoch}".encode(),
                                "params": lambda t: Path(t).write_text(
                                    str(epoch))}, step=10 * epoch,
                        meta={"note": epoch})


def test_rotation_keeps_the_newest_n_and_deletes_the_rest(tmp_path):
    m = ckpt.CheckpointManager(tmp_path, keep=2)
    for e in range(4):
        paths = _save(m, e)
    assert m.epochs() == [2, 3] and m.last_good == 3
    assert Path(paths["states"]).read_bytes() == b"epoch 3"
    assert sorted(p for p in os.listdir(tmp_path) if p != "MANIFEST.json") \
        == ["ckpt-0002.params", "ckpt-0002.states", "ckpt-0003.params",
            "ckpt-0003.states"]
    entry, _ = ckpt.CheckpointManager(tmp_path).load()
    assert (entry["epoch"], entry["step"], entry["meta"]) == \
        (3, 30, {"note": 3})


def test_a_corrupt_newest_checkpoint_falls_back(tmp_path):
    m = ckpt.CheckpointManager(tmp_path, keep=3)
    assert m.resume() is None
    for e in range(3):
        _save(m, e)
    newest = tmp_path / "ckpt-0002.states"
    newest.write_bytes(newest.read_bytes()[:-2])
    with pytest.warns(UserWarning, match="falling back to epoch 1"):
        entry, paths = m.resume()
    assert entry["epoch"] == 1 and \
        Path(paths["states"]).read_bytes() == b"epoch 1"
    for e in (0, 1):
        (tmp_path / f"ckpt-000{e}.params").write_text("x")
    with pytest.raises(ValueError, match="failed checksum"):
        m.load()
    (tmp_path / "MANIFEST.json").write_text("{torn")
    with pytest.warns(UserWarning, match="corrupt checkpoint manifest"):
        assert ckpt.CheckpointManager(tmp_path).resume() is None


@pytest.mark.parametrize("writer,reader", [(jckpt, ckpt), (ckpt, jckpt)])
def test_either_package_reads_the_others_manifest(tmp_path, writer, reader):
    w = writer.CheckpointManager(tmp_path, prefix="run", keep=2)
    for e in range(3):
        _save(w, e)
    r = reader.CheckpointManager(tmp_path, prefix="run", keep=2)
    assert r.epochs() == [1, 2] and r.last_good == 2
    entry, paths = r.load()
    assert entry["files"] == w._manifest["checkpoints"][-1]["files"]
    assert Path(paths["states"]).read_bytes() == b"epoch 2"
    _save(r, 3)
    again = writer.CheckpointManager(tmp_path, prefix="run", keep=2)
    assert again.epochs() == [2, 3] and again.verify(again.load()[0])
    assert set(json.loads((tmp_path / "MANIFEST.json").read_text())) == \
        {"version", "prefix", "checkpoints", "last_good"}


def test_host_metadata_names_torch_and_the_device():
    meta = ckpt.host_metadata()
    assert meta["torch"] == torch.__version__ and meta["process_count"] == 1
    assert meta["backend"] in ("cpu", "gpu") and meta["device_count"] >= 1
    json.dumps(meta)


# ---- trainer state -----------------------------------------------------------

X = np.random.RandomState(0).rand(4, 3, 8, 8).astype(np.float32)
Y = np.random.RandomState(1).randint(0, 3, 4).astype(np.float32)


def _small(pkg, **ctx):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Conv2D(4, 3, padding=1, in_channels=3,
                                    use_bias=False),
                pkg.gluon.nn.BatchNorm(in_channels=4),
                pkg.gluon.nn.Activation("relu"),
                pkg.gluon.nn.GlobalAvgPool2D(),
                pkg.gluon.nn.Dense(3, in_units=4))
    return net


def _jax_trainer(scheduler=True):
    jmx.random.seed(3)
    net = _small(jmx)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(X))
    net.cast("bfloat16")
    params = dict(HYPER)
    if scheduler:
        params["lr_scheduler"] = jsched.MultiFactorScheduler([2, 4], 0.1)
    return net, JaxTrainer(net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                           "sgd", params, mesh=JaxMesh({"dp": 1}))


def _port_trainer(scheduler=True, seed=0):
    net = _small(mx)
    net.initialize(mx.init.Xavier(), ctx=CPU,
                   generator=torch.Generator().manual_seed(seed))
    net(mx.nd.array(X, ctx=CPU))
    net.cast("bfloat16")
    params = dict(HYPER)
    if scheduler:
        params["lr_scheduler"] = sched.MultiFactorScheduler([2, 4], 0.1)
    return net, ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                               "sgd", params,
                               mesh=DeviceMesh({"dp": 1}, devices=[CPU]))


def _port_step(st):
    return st.step(mx.nd.array(X, ctx=CPU).astype("bfloat16"),
                   mx.nd.array(Y, ctx=CPU)).asscalar()


def _jax_arrays(jst):
    out = {f"p{i}": h._data for i, h in enumerate(jst._train_handles)}
    out.update({f"a{i}": h._data for i, h in enumerate(jst._aux_handles)})
    for i, per in enumerate(jst._opt_raws):
        out.update({f"s{i}_{j}": s for j, s in enumerate(per)})
    return out


def _bits_equal(t, j):
    """A port tensor and a JAX array: same dtype, same bits."""
    assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    if t.dtype == torch.bfloat16:
        return np.array_equal(t.view(torch.int16).numpy(),
                              np.asarray(j).view(np.int16))
    return np.array_equal(t.numpy(), np.asarray(j))


def test_a_jax_checkpoint_loads_into_the_port_in_full(tmp_path):
    _, jst = _jax_trainer()
    for _ in range(3):
        jst.step(jmx.nd.array(X).astype("bfloat16"), jmx.nd.array(Y))
    fname = str(tmp_path / "jax.states")
    jst.save_states(fname)
    _, st = _port_trainer()
    assert st._ckpt_keys() == jst._ckpt_keys()
    st.load_states(fname)
    got = st._state_tensors()
    assert set(got) == set(_jax_arrays(jst))
    for key, j in _jax_arrays(jst).items():
        assert _bits_equal(got[key], j), key
    assert st._t == jst._t == 3
    assert type(st._lr_scheduler) is sched.MultiFactorScheduler
    assert vars(st._lr_scheduler) == vars(jst._lr_scheduler)
    assert st.learning_rate == jst.learning_rate
    # the threefry key restores the seed alone
    assert mx.random.current_seed() == jmx.random.current_seed() == 3
    assert np.isfinite(_port_step(st))


def test_the_ports_checkpoint_loads_into_the_jax_trainer(tmp_path):
    _, jst = _jax_trainer(scheduler=False)
    _, st = _port_trainer(scheduler=False)
    for _ in range(2):
        _port_step(st)
    fname = str(tmp_path / "port.states")
    st.save_states(fname)
    jst.load_states(fname)
    for key, j in _jax_arrays(jst).items():
        assert _bits_equal(st._state_tensors()[key], j), key
    assert jst._t == st._t == 2
    jmx.random.seed(0)   # the sample stream does not cross
    loss = jst.step(jmx.nd.array(X).astype("bfloat16"), jmx.nd.array(Y))
    assert np.isfinite(float(loss.asscalar()))


def test_load_states_checks_keys_and_shapes_before_it_changes_anything(
        tmp_path):
    _, st = _port_trainer()
    _port_step(st)
    fname = str(tmp_path / "a.states")
    st.save_states(fname)
    before = {k: t.clone() for k, t in st._state_tensors().items()}
    _, other = _port_trainer(scheduler=False)
    with pytest.raises(ValueError, match="unexpected.*__sched__"):
        other.load_states(fname)
    arrays = mx.nd.load(fname, ctx=CPU)
    arrays["s0_1"] = mx.nd.array(np.zeros((2, 2), np.float32), ctx=CPU)
    mx.nd.save(fname, arrays)
    _port_step(st)
    after = {k: t.clone() for k, t in st._state_tensors().items()}
    with pytest.raises(ValueError, match="'s0_1' has shape"):
        st.load_states(fname)
    assert all(torch.equal(after[k], t)
               for k, t in st._state_tensors().items())
    assert not all(torch.equal(before[k], after[k]) for k in before)
    with pytest.raises(FileNotFoundError):
        st.load_states(str(tmp_path / "missing"))
    Path(fname).write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="corrupt trainer state"):
        st.load_states(fname)


def test_resume_is_bit_exact_against_an_uninterrupted_run(tmp_path):
    mx.random.seed(5)
    _, ref = _port_trainer(seed=1)
    ref_lrs, ref_losses = [], []
    for _ in range(6):
        ref_lrs.append(ref.learning_rate)
        ref_losses.append(_port_step(ref))
    want = {k: t.clone() for k, t in ref._state_tensors().items()}

    mx.random.seed(5)
    _, st = _port_trainer(seed=1)
    manager = ckpt.CheckpointManager(tmp_path, keep=2)
    lrs = []
    for _ in range(3):
        lrs.append(st.learning_rate)
        _port_step(st)
    st.save_checkpoint(manager, epoch=1)
    saved = {k: t.clone() for k, t in st._state_tensors().items()}
    _port_step(st)
    st.save_checkpoint(manager, epoch=2)
    # the newest file torn: resume falls back to epoch 1
    newest = tmp_path / "ckpt-0002.states"
    newest.write_bytes(newest.read_bytes()[:100])

    mx.random.seed(99)
    _, fresh = _port_trainer(seed=2)
    with pytest.warns(UserWarning, match="falling back to epoch 1"):
        entry = fresh.resume(manager)
    assert entry["epoch"] == 1 and entry["step"] == 3
    assert entry["meta"]["topology"]["mesh"]["axes"] == {"dp": 1}
    assert all(torch.equal(saved[k], t)
               for k, t in fresh._state_tensors().items())
    assert fresh._t == 3 and mx.random.current_seed() == 5
    losses = []
    for _ in range(3):
        lrs.append(fresh.learning_rate)
        losses.append(_port_step(fresh))
    assert lrs == ref_lrs == [0.05, 0.05, 0.05, 0.005000000000000001,
                              0.005000000000000001, 0.0005000000000000001]
    assert losses == ref_losses[3:]
    assert all(torch.equal(want[k], t)
               for k, t in fresh._state_tensors().items())


def test_data_iter_and_reshard_stay_refused(tmp_path):
    """``reshard=`` is ported (tests/test_torch_trainer_options.py holds
    it against a JAX checkpoint from another mesh): with no checkpoint
    recorded it returns None, and on the saving topology
    ``reshard=False`` resumes. ``data_iter=`` is ported (the data plane's
    iterators have ``state_dict``): the checkpoint carries the stream
    position and resume restores it."""
    _, st = _port_trainer()
    manager = ckpt.CheckpointManager(tmp_path)
    assert st.resume(manager, reshard=True) is None
    assert st.resume(manager) is None
    with mx.cpu():
        it = mx.io.NDArrayIter(np.arange(12, dtype=np.float32).reshape(
            12, 1), batch_size=3, shuffle=True,
            rng=np.random.RandomState(0))
        it.next()
        st.save_checkpoint(manager, 0, data_iter=it)
        rest = [b.data[0].asnumpy() for b in it]
        fresh = mx.io.NDArrayIter(np.arange(12, dtype=np.float32).reshape(
            12, 1), batch_size=3)
        entry = st.resume(manager, reshard=False, data_iter=fresh)
        assert entry["meta"]["data_state"]["kind"] == "NDArrayIter"
        got = [b.data[0].asnumpy() for b in fresh]
    assert len(got) == len(rest) == 3
    assert all(np.array_equal(a, b) for a, b in zip(got, rest))


def test_a_process_with_only_the_port_reads_a_jax_checkpoint(tmp_path):
    _, jst = _jax_trainer()
    for _ in range(2):
        jst.step(jmx.nd.array(X).astype("bfloat16"), jmx.nd.array(Y))
    manager = jckpt.CheckpointManager(tmp_path / "ckpt")
    jst.save_checkpoint(manager, epoch=0)
    want = np.asarray(jnp.asarray(jst._opt_raws[0][0]))
    np.save(tmp_path / "master0.npy", want)
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import mxnet_tpu_torch as mx\n"
        "from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer\n"
        "cpu = mx.cpu()\n"
        "net = mx.gluon.nn.HybridSequential()\n"
        "with net.name_scope():\n"
        "    net.add(mx.gluon.nn.Conv2D(4, 3, padding=1, in_channels=3,\n"
        "                               use_bias=False),\n"
        "            mx.gluon.nn.BatchNorm(in_channels=4),\n"
        "            mx.gluon.nn.Activation('relu'),\n"
        "            mx.gluon.nn.GlobalAvgPool2D(),\n"
        "            mx.gluon.nn.Dense(3, in_units=4))\n"
        "net.initialize(ctx=cpu)\n"
        "net(mx.nd.array(np.ones((1, 3, 8, 8), np.float32), ctx=cpu))\n"
        "net.cast('bfloat16')\n"
        "st = ShardedTrainer(\n"
        "    net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), 'sgd',\n"
        f"    dict({HYPER!r}, lr_scheduler=mx.lr_scheduler\n"
        "         .MultiFactorScheduler([2, 4], 0.1)),\n"
        "    mesh=DeviceMesh({'dp': 1}, devices=[cpu]))\n"
        f"m = mx.checkpoint.CheckpointManager({str(tmp_path / 'ckpt')!r})\n"
        "entry = st.resume(m)\n"
        "assert entry['step'] == 2 and st._t == 2\n"
        "assert type(st._lr_scheduler).__module__ == "
        "'mxnet_tpu_torch.lr_scheduler'\n"
        f"want = np.load({str(tmp_path / 'master0.npy')!r})\n"
        "assert np.array_equal(st._opt_state[0][0].numpy(), want)\n"
        "assert 'jax' not in sys.modules and 'mxnet_tpu' not in sys.modules\n")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
