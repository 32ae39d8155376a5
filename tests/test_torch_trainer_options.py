"""ShardedTrainer's options on a mesh of one device, on the CPU, against
the JAX package's trainer: ``zero``, sharding ``rules`` and
``sharding_rules``, ``donate=False``, ``warmup``, ``unshard``,
``resume(reshard=)`` of a JAX checkpoint written on an 8-device mesh,
and ``aot_lower``.

The model is examples/gluon/transformer_finetune.py's classifier at 64
units and 2 layers (``SMALL``), from the same weights in both packages.
Tolerances: each step's loss within rtol 1e-5 of the JAX trainer's, and
every parameter after 3 "adam" steps within 1e-2 * lr (the attention
key biases, whose true gradient is zero and whose Adam steps are
rounding noise scaled to about lr, within 1 * lr), as in
tests/test_torch_train.py. Everything the port holds against itself
(zero against the plain step, donate=False against donate=True, a
warmed trainer against a cold one, a resumed state against the file) is
bit for bit.
"""
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import build_classifier, make_task, random_params
from mxnet_tpu.checkpoint import CheckpointManager as JaxManager
from mxnet_tpu.parallel import DeviceMesh as JaxMesh
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import sharded_trainer as jst_mod
from mxnet_tpu_torch import compile as C
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch import random as mx_random
from mxnet_tpu_torch.checkpoint import CheckpointManager
from mxnet_tpu_torch.convert import export_params, load_jax_params
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer
from mxnet_tpu_torch.parallel import sharded_trainer as st_mod

SMALL = {"vocab": 100, "units": 64, "hidden": 128, "heads": 4, "layers": 2,
         "seq_len": 16, "num_classes": 4}
BATCH, STEPS = 8, 3
CPU = mx.cpu()
LOSS_RTOL = 1e-5
ADAM = {"learning_rate": 1e-3, "wd": 1e-4}


@pytest.fixture(scope="module")
def task():
    return make_task(BATCH * STEPS, SMALL["seq_len"], SMALL["vocab"],
                     SMALL["num_classes"], seed=5)


@pytest.fixture(scope="module")
def weights():
    return random_params(SMALL, seed=0)


def _port(weights, **kw):
    clf = build_classifier(mx, SMALL, prefix="clf_")
    clf.initialize(ctx=CPU)
    load_jax_params(clf, weights)
    st = ShardedTrainer(clf, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                        dict(ADAM), mesh=DeviceMesh({"dp": 1}, devices=[CPU]),
                        **kw)
    return clf, st


def _jax(weights, x, mesh=None, **kw):
    clf = build_classifier(jmx, SMALL)
    clf.initialize(jmx.init.Xavier())
    clf(jmx.nd.array(x[:2]))
    for name, p in clf._collect_params_with_structure().items():
        p.set_data(jmx.nd.array(weights[name]))
    st = JaxTrainer(clf, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                    dict(ADAM), mesh=mesh or JaxMesh({"dp": 1}), **kw)
    return clf, st


def _batch(x, y, i):
    return x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH]


def _state(st):
    return [t.clone() for t in st._state_tensors().values()]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def test_zero_steps_match_jax_and_the_plain_step(task, weights):
    """``zero=True`` on one device: three "adam" steps against the JAX
    trainer's ``zero=True`` steps (loss rtol 1e-5, parameters 1e-2 * lr)
    and bit for bit against the port's ``zero=False`` steps."""
    x, y = task
    clf, st = _port(weights, zero=True)
    _, plain = _port(weights)
    jclf, jst = _jax(weights, x, zero=True)
    for i in range(STEPS):
        xb, yb = _batch(x, y, i)
        got = st.step(xb, yb).asscalar()
        assert got == plain.step(xb, yb).asscalar()
        want = jst.step(jmx.nd.array(xb), jmx.nd.array(yb)).asscalar()
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert _equal(_state(st), _state(plain))
    assert st.topology_meta()["zero"] is True
    assert plain.topology_meta()["zero"] is False
    got = export_params(clf)
    want = {n: p.data().asnumpy()
            for n, p in jclf._collect_params_with_structure().items()}
    lr = ADAM["learning_rate"]
    for name in want:
        noise = name.endswith("attn.key.bias")
        np.testing.assert_allclose(got[name], want[name], rtol=0,
                                   atol=(1.0 if noise else 1e-2) * lr,
                                   err_msg=name)


class _Mesh:
    """A mesh of the given axis sizes for ``sharding_rules``, which reads
    ``size`` alone (the port builds no mesh of more than one device)."""

    def __init__(self, **sizes):
        self.sizes = sizes

    def size(self, axis):
        return self.sizes.get(axis, 1)


@pytest.mark.parametrize("tp", [1, 2, 3])
def test_sharding_rules_equal_jax(weights, tp):
    """The defaults for the classifier's parameters, by structural name,
    equal the JAX function's on meshes with tp 1, 2 and 3."""
    clf = build_classifier(mx, SMALL)
    clf.initialize(ctx=CPU)
    load_jax_params(clf, weights)
    params = {n: p for n, p in clf._collect_params_with_structure().items()}
    got = st_mod.sharding_rules(params, _Mesh(tp=tp))
    want = jst_mod.sharding_rules(params, _Mesh(tp=tp))
    assert got == want
    assert any(got.values()) == (tp == 2)


def test_rules_are_checked_against_the_mesh(weights):
    """A rule naming an axis the mesh lacks raises a ValueError naming the
    parameter, with the JAX mesh's own ``axis_error`` text; one axis on
    two dimensions and a spec longer than its array raise too; a rule
    naming no parameter warns; a valid rule trains and is recorded."""
    clf, st = _port(weights)
    name = next(n for n in st._param_names if n.endswith("weight"))
    shape = dict(zip(st._param_names, (h.shape for h in
                                       st._train_handles)))[name]
    jaxmesh = JaxMesh({"dp": 1})
    for rules, match in (({name: ("dpp",)}, jaxmesh.axis_error("dpp")),
                         ({name: ("dp", "dp")}, "more than one dimension"),
                         ({name: (None,) * (len(shape) + 1)}, "entries for")):
        with pytest.raises(ValueError) as e:
            _port(weights, rules=rules)
        assert name in str(e.value) and match in str(e.value)
    assert "did you mean 'dp'?" in jaxmesh.axis_error("dpp")
    with pytest.warns(UserWarning, match="names no known parameter"):
        _port(weights, rules={name + "x": ("dp",)})
    clf, st = _port(weights, rules={name: ("dp", None)})
    assert st.topology_meta()["param_sharding"][name] == ["dp", None]
    assert mx.parallel.DeviceMesh({"dp": 1}, devices=[CPU]).axis_error(
        "dpp") == jaxmesh.axis_error("dpp")


def test_donate_false_keeps_the_tensors_taken_before_a_step(task, weights):
    """With ``donate=False`` a parameter's and an optimizer state's tensor
    taken before a step keep their values after it, the handles hold new
    tensors, and the trajectory equals ``donate=True``'s bit for bit,
    including a caller's write into a handed-out tensor between steps."""
    x, y = task
    _, kept = _port(weights, donate=False)
    _, donated = _port(weights)
    for i in range(STEPS):
        xb, yb = _batch(x, y, i)
        p_before = kept._train_handles[0]._data
        s_before = kept._opt_state[0][0]
        p_val, s_val = p_before.clone(), s_before.clone()
        assert kept.step(xb, yb).asscalar() == \
            donated.step(xb, yb).asscalar()
        assert torch.equal(p_before, p_val) and torch.equal(s_before, s_val)
        assert kept._train_handles[0]._data is not p_before
        assert not torch.equal(kept._train_handles[0]._data, p_val)
        assert _equal(_state(kept), _state(donated))
        if i == 0:   # an in-place write and a rebind reach the next step
            for st in (kept, donated):
                st._train_handles[1]._data.mul_(0.5)
                st._aux_handles and st._aux_handles[0]._data.add_(1.0)
            p = kept._train_handles[2]
            p._data = p._data * 2.0
            donated._train_handles[2]._data.mul_(2.0)
    # predict reads the same weights and keeps one entry
    np.testing.assert_array_equal(kept.predict(x).asnumpy(),
                                  donated.predict(x).asnumpy())


def test_warmup_changes_nothing_and_the_next_step_matches(task, weights):
    """``warmup`` makes the step's entry (one more miss, no hit) and leaves
    the parameters, optimizer state, step count, skip counters and the
    generator as they were; the next step is a hit on that entry, equal
    bit for bit to a trainer that did not warm up. A Dropout in the
    model shows the generator restored: the two trainers draw the same
    mask."""
    x, y = task
    xb, yb = _batch(x, y, 0)

    def dropout_trainer():
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(64, activation="relu", in_units=16),
                mx.gluon.nn.Dropout(0.5),
                mx.gluon.nn.Dense(4, in_units=64))
        net.initialize(mx.init.Xavier(), ctx=CPU)
        return ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              "adam", dict(ADAM),
                              mesh=DeviceMesh({"dp": 1}, devices=[CPU]))

    for make in (lambda: _port(weights)[1], dropout_trainer):
        warm, cold = make(), make()
        with torch.no_grad():   # one set of weights
            for dst, src in zip(cold._state_tensors().values(),
                                warm._state_tensors().values()):
                dst.copy_(src)
        mx_random.seed(3)
        before = _state(warm)
        gen = mx_random.generator(torch.device("cpu")).get_state()
        fn = warm._step_fn.stats()
        report = warm.warmup(xb, ((BATCH,), "float32"))
        assert report["entries"] == 0 and report["errors"] == []
        after = warm._step_fn.stats()
        assert (after["misses"] - fn["misses"], after["hits"]) == (1, 0)
        assert _equal(_state(warm), before)
        assert torch.equal(mx_random.generator(
            torch.device("cpu")).get_state(), gen)
        assert (warm._t, warm.skipped_steps, warm.consecutive_skips) == \
            (0, 0, 0)
        loss = warm.step(xb, yb).asscalar()
        assert warm._step_fn.stats()["hits"] == 1
        assert warm._step_fn.stats()["misses"] == after["misses"]
        mx_random.seed(3)
        assert cold.step(xb, yb).asscalar() == loss
        assert _equal(_state(warm), _state(cold))
        # a signature already made is left alone
        warm.warmup(xb, yb)
        assert warm._step_fn.stats()["misses"] == after["misses"]


def test_unshard_copies_the_weights_and_training_goes_on(task, weights):
    """``unshard(ctx=mx.cpu())`` rebinds every handle to a copy with the
    same values; the block's own forward then equals ``predict``; the
    next step puts the weights back and trains as a trainer that never
    unsharded."""
    x, y = task
    clf, st = _port(weights)
    _, ref = _port(weights)
    xb, yb = _batch(x, y, 0)
    st.step(xb, yb)
    ref.step(xb, yb)
    before = [h._data for h in st._train_handles + st._aux_handles]
    pred = st.predict(x).asnumpy()
    st.unshard(ctx=mx.cpu())
    for h, t in zip(st._train_handles + st._aux_handles, before):
        assert h._data is not t and torch.equal(h._data, t)
        assert h._data.device == torch.device("cpu")
    with mx.cpu():
        np.testing.assert_array_equal(clf(mx.nd.array(x)).asnumpy(), pred)
    xb, yb = _batch(x, y, 1)
    assert st.step(xb, yb).asscalar() == ref.step(xb, yb).asscalar()
    assert _equal(_state(st), _state(ref))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory, task, weights):
    """A JAX trainer with ``zero=True`` on an 8-device CPU mesh, two steps,
    saved through its CheckpointManager."""
    x, y = task
    d = tmp_path_factory.mktemp("jax_ckpt")
    jclf, jst = _jax(weights, x, mesh=JaxMesh({"dp": 8}), zero=True)
    for i in range(2):
        xb, yb = _batch(x, y, i)
        jst.step(jmx.nd.array(xb), jmx.nd.array(yb))
    jst.save_checkpoint(JaxManager(str(d)), 1)
    want = {n: p.data().asnumpy()
            for n, p in jclf._collect_params_with_structure().items()}
    return str(d), want, jst._t


def test_resume_of_a_jax_8_device_checkpoint(jax_checkpoint, weights,
                                             monkeypatch):
    """The JAX checkpoint resumes on ``{"dp": 1}`` with a warning that
    names the topology change, bit for bit; ``reshard=False`` and
    ``MXNET_TPU_PREEMPT_RESHARD=0`` raise a ValueError naming both
    meshes, and leave the trainer as it was."""
    path, want, t = jax_checkpoint
    clf, st = _port(weights, zero=True)
    before = _state(st)
    for kw, env in (({"reshard": False}, None), ({}, "0")):
        if env is not None:
            monkeypatch.setenv("MXNET_TPU_PREEMPT_RESHARD", env)
        with pytest.raises(ValueError) as e:
            st.resume(CheckpointManager(path), **kw)
        msg = str(e.value)
        assert "DeviceMesh({'dp': 8})" in msg and \
            "DeviceMesh({'dp': 1})" in msg and "device count 8 -> 1" in msg
        assert _equal(_state(st), before) and st._t == 0
    monkeypatch.delenv("MXNET_TPU_PREEMPT_RESHARD")
    with pytest.warns(UserWarning, match="topology change"):
        entry = st.resume(CheckpointManager(path))
    assert entry["epoch"] == 1 and st._t == t
    got = export_params(clf)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # the same topology resumes silently
    d2 = path + "_port"
    st.save_checkpoint(CheckpointManager(d2), 2)
    _, again = _port(weights, zero=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again.resume(CheckpointManager(d2), reshard=False)
    assert _equal(_state(again), _state(st))


def test_aot_lower_names_the_kernels_and_runs_nothing(task, weights):
    """``aot_lower`` of (shape, dtype) pairs traces the step on fake
    tensors: its text names K2 (``opt_adam``) and K3 and K3-bwd by
    family, its flops are those the first real step counts, and nothing
    ran: no state, step count, generator, compile entry or launch count
    changed. ``compile()`` then captures it as ``warmup`` does."""
    from mxnet_tpu_torch.telemetry import costs

    x, y = task
    _, st = _port(weights)
    before = _state(st)
    gen = mx_random.generator(torch.device("cpu")).get_state()
    stats = C.stats().get("trainer", {}).get("misses", 0)
    launches = kernels.launch_counts()
    low = st.aot_lower(((BATCH, SMALL["seq_len"]), "float32"),
                       ((BATCH,), np.float32))
    text = low.as_text()
    lines = text.splitlines()
    for family, n in (("opt_adam", 1), ("flash_attention", 2),
                      ("flash_attention_bwd_dq", 2),
                      ("flash_attention_bwd_dkv", 2)):
        assert lines.count(f"kernel {family}") == n, family
    assert any(line.startswith("aten.") for line in lines)
    assert _equal(_state(st), before) and st._t == 0
    assert torch.equal(mx_random.generator(torch.device("cpu")).get_state(),
                       gen)
    assert C.stats().get("trainer", {}).get("misses", 0) == stats
    assert kernels.launch_counts() == launches
    assert low.flops > 0 and low.int_ops == 0
    low.compile()
    assert st._t == 0 and _equal(_state(st), before)
    xb, yb = _batch(x, y, 0)
    st.step(xb, yb)
    assert st._step_fn.stats()["hits"] == 1
    assert costs.flops_for(st._step_fn._token_key) == low.flops


def test_checkpoints_cross_between_zero_settings_and_packages(
        tmp_path, task, weights):
    """A ``zero=True`` trainer's ``save_states`` loads into a
    ``zero=False`` trainer of the port and of the JAX package, and a JAX
    ``zero=False`` file loads into a port ``zero=True`` trainer: the
    arrays are in host layout, so the setting changes nothing in the
    file (every array equal bit for bit after the load)."""
    x, y = task
    _, st = _port(weights, zero=True)
    for i in range(2):
        st.step(*_batch(x, y, i))
    path = str(tmp_path / "zero.states")
    st.save_states(path)
    _, plain = _port(weights)
    plain.load_states(path)
    assert _equal(_state(plain), _state(st)) and plain._t == 2
    jclf, jst = _jax(weights, x)
    jst.load_states(path)
    want = export_params(st._net)
    for name, p in jclf._collect_params_with_structure().items():
        np.testing.assert_array_equal(p.data().asnumpy(), want[name],
                                      err_msg=name)
    # the port's __rng_key__ is a torch generator state, not a threefry
    # key: the JAX trainer's next step needs a seed
    jmx.random.seed(0)
    jst.step(jmx.nd.array(_batch(x, y, 2)[0]),
             jmx.nd.array(_batch(x, y, 2)[1]))
    jpath = str(tmp_path / "jax.states")
    jst.save_states(jpath)
    clf, back = _port(weights, zero=True)
    back.load_states(jpath)
    assert back._t == 3
    got = export_params(clf)
    for name, p in jclf._collect_params_with_structure().items():
        np.testing.assert_array_equal(got[name], p.data().asnumpy(),
                                      err_msg=name)
