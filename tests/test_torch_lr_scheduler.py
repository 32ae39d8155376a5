"""The port's learning-rate schedules against the JAX package's.

Both are pure Python floats computed in the same order, so every
schedule, warmup ramps included, agrees exactly over updates 0..N. The
argument checks raise the same errors, and a scheduler the JAX package
pickled (naming ``mxnet_tpu.lr_scheduler`` classes) reads as the port's
class of the same name, in a process that imports only the port too.
The optimizer and trainer surface that reads the schedule (the
scheduled ``learning_rate``, ``set_learning_rate``'s UserWarning,
``base_lr`` from ``learning_rate``) is held against the JAX package's as
well.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import lr_scheduler as jsched
from mxnet_tpu_torch import lr_scheduler as sched
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

N = 60
CASES = [
    ("FactorScheduler", dict(step=7, factor=0.5, stop_factor_lr=1e-3,
                             base_lr=0.4)),
    ("FactorScheduler", dict(step=5, factor=0.9, base_lr=0.1,
                             warmup_steps=4, warmup_begin_lr=0.01)),
    ("MultiFactorScheduler", dict(step=[2, 4], factor=0.1, base_lr=0.05)),
    ("MultiFactorScheduler", dict(step=[10, 20, 45], factor=0.3,
                                  base_lr=0.2, warmup_steps=6,
                                  warmup_mode="constant",
                                  warmup_begin_lr=0.02)),
    ("PolyScheduler", dict(max_update=40, base_lr=0.1, pwr=2,
                           final_lr=1e-4)),
    ("PolyScheduler", dict(max_update=50, base_lr=0.3, pwr=1.5,
                           warmup_steps=5, warmup_begin_lr=0.05)),
    ("CosineScheduler", dict(max_update=45, base_lr=0.1, final_lr=0.001)),
    ("CosineScheduler", dict(max_update=30, base_lr=0.5, warmup_steps=10)),
]


@pytest.mark.parametrize("name,kwargs", CASES)
def test_schedules_equal_the_jax_package_exactly(name, kwargs):
    got = getattr(sched, name)(**kwargs)
    want = getattr(jsched, name)(**kwargs)
    assert [got(t) for t in range(N + 1)] == [want(t) for t in range(N + 1)]
    # base_lr set after construction (Optimizer and ShardedTrainer do it)
    got.base_lr = want.base_lr = 0.7
    assert [got(t) for t in range(N + 1)] == [want(t) for t in range(N + 1)]
    assert vars(got) == vars(want)


BAD = [
    ("FactorScheduler", dict(step=0)),
    ("FactorScheduler", dict(step=2, factor=1.5)),
    ("MultiFactorScheduler", dict(step=[])),
    ("MultiFactorScheduler", dict(step=(2, 3))),
    ("MultiFactorScheduler", dict(step=[0, 3])),
    ("MultiFactorScheduler", dict(step=[3, 3])),
    ("MultiFactorScheduler", dict(step=[2], factor=2.0)),
    ("PolyScheduler", dict(max_update=0)),
    ("PolyScheduler", dict(max_update=3.0)),
    ("CosineScheduler", dict(max_update=5, warmup_steps=5)),
    ("CosineScheduler", dict(max_update=5, warmup_steps=-1)),
    ("FactorScheduler", dict(step=2, warmup_mode="cubic")),
    ("FactorScheduler", dict(step=2, base_lr=0.1, warmup_begin_lr=0.2)),
]


@pytest.mark.parametrize("name,kwargs", BAD)
def test_argument_errors_match(name, kwargs):
    with pytest.raises(ValueError) as want:
        getattr(jsched, name)(**kwargs)
    with pytest.raises(ValueError) as got:
        getattr(sched, name)(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name,kwargs", CASES)
def test_a_jax_pickled_scheduler_reads_as_the_ports(name, kwargs):
    blob = pickle.dumps(getattr(jsched, name)(**kwargs))
    assert b"mxnet_tpu.lr_scheduler" in blob
    got = sched.loads(blob)
    assert type(got) is getattr(sched, name)
    want = getattr(jsched, name)(**kwargs)
    assert [got(t) for t in range(N + 1)] == [want(t) for t in range(N + 1)]
    # the port's own pickle round-trips through the same reader
    again = sched.loads(pickle.dumps(got))
    assert type(again) is type(got) and vars(again) == vars(got)


def test_a_pickle_naming_any_other_class_is_refused():
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))

    with pytest.raises(pickle.UnpicklingError, match="posix.system|system"):
        sched.loads(pickle.dumps(Evil()))
    with pytest.raises(pickle.UnpicklingError, match="LRScheduler"):
        sched.loads(pickle.dumps(jsched.LRScheduler()))


def test_a_process_with_only_the_port_reads_a_jax_pickle():
    """The JAX package is not imported to read its pickle: the class
    names map to the port's."""
    blob = pickle.dumps(jsched.MultiFactorScheduler([2, 4], 0.1,
                                                    base_lr=0.05))
    code = (
        "import sys\n"
        "import mxnet_tpu_torch as mx\n"
        f"s = mx.lr_scheduler.loads({blob!r})\n"
        "assert [s(t) for t in range(6)] == "
        "[0.05, 0.05, 0.05, 0.005000000000000001, 0.005000000000000001, "
        "0.0005000000000000001]\n"
        "assert 'jax' not in sys.modules and 'mxnet_tpu' not in sys.modules\n")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_optimizer_reads_the_schedule_as_the_jax_optimizer_does():
    got = mx.optimizer.SGD(learning_rate=0.2, momentum=0.9,
                           lr_scheduler=sched.FactorScheduler(2, 0.5))
    want = jmx.optimizer.SGD(learning_rate=0.2, momentum=0.9,
                             lr_scheduler=jsched.FactorScheduler(2, 0.5))
    assert got.lr_scheduler.base_lr == want.lr_scheduler.base_lr == 0.2
    for n in range(7):
        got.num_update = want.num_update = n
        assert got.learning_rate == want.learning_rate
        assert got._get_lrs([0]) == want._get_lrs([0])
    for opt in (got, want):
        with pytest.raises(UserWarning, match="already been defined"):
            opt.set_learning_rate(0.1)
    plain = mx.optimizer.SGD(learning_rate=0.2)
    plain.set_learning_rate(0.1)
    assert plain.learning_rate == 0.1


def test_sharded_trainer_takes_a_scheduler_from_params_or_the_optimizer():
    cpu = mx.cpu()
    net = mx.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=cpu)
    mesh = DeviceMesh({"dp": 1}, devices=[cpu])
    s = sched.MultiFactorScheduler([2, 4], 0.1)
    st = ShardedTrainer(net, mx.gluon.loss.L2Loss(), "sgd",
                        {"learning_rate": 0.05, "lr_scheduler": s},
                        mesh=mesh)
    assert s.base_lr == 0.05
    x = np.ones((2, 4), np.float32)
    y = np.zeros((2, 3), np.float32)
    seen = []
    for _ in range(5):
        seen.append(st.learning_rate)
        st.step(mx.nd.array(x, ctx=cpu), mx.nd.array(y, ctx=cpu))
        assert float(st._lr_dev) == np.float32(s(st._t))
    assert seen == [s(t) for t in range(5)]
    with pytest.raises(UserWarning, match="already been defined"):
        st.learning_rate = 0.3
    opt = mx.optimizer.SGD(learning_rate=0.3,
                           lr_scheduler=sched.CosineScheduler(10))
    st = ShardedTrainer(net, mx.gluon.loss.L2Loss(), opt, mesh=mesh)
    assert st._lr_scheduler is opt.lr_scheduler
    assert st.learning_rate == opt.lr_scheduler(0) == 0.3
