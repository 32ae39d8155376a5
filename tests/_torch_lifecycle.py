"""Shared pieces of the port's lifecycle tests (watchdog, preempt,
profiler, estimator): a fixture that leaves no lifecycle state behind,
and a tiny trainer on the CPU."""
import os
import threading

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import faults, preempt, profiler, watchdog

CPU = mx.cpu()

# the variables a test may set; the fixture puts each back as it was
LIFECYCLE_ENV = ("MXNET_TPU_PREEMPT", "MXNET_TPU_PREEMPT_DIR",
                 "MXNET_TPU_PREEMPT_EXIT_CODE", "MXNET_TPU_WATCHDOG",
                 "MXNET_TPU_CRASH_DIR", "MXNET_TPU_FAULTS")


def monitor_threads():
    """The port's live watchdog monitors (the JAX package's, in the same
    process, carry the same thread name)."""
    return [t for t in threading.enumerate() if t.is_alive() and
            getattr(t, "_target", None) is watchdog._monitor_loop]


@pytest.fixture(autouse=True)
def lifecycle_clean():
    """Before and after each test: no drain handlers or flag, no
    last-resort hook, no fault schedule, no profiler session or events,
    the environment as it was and the ambient watchdog configuration
    (the monitor of any other one retired)."""
    saved = {k: os.environ.get(k) for k in LIFECYCLE_ENV}
    faults.reset()
    preempt.uninstall()
    watchdog.set_last_resort(None)
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    faults.reset()
    preempt.uninstall()
    watchdog.set_last_resort(None)
    watchdog.configure_from_env()
    profiler.set_state("stop")
    profiler.reset()


def batch(step, n=8, din=6, dout=4):
    rs = np.random.RandomState(1000 + step)
    x = rs.randn(n, din).astype(np.float32)
    y = (x @ rs.randn(din, dout) * 0.5).astype(np.float32)
    return mx.nd.array(x, ctx=CPU), mx.nd.array(y, ctx=CPU)


def make_trainer(seed=7, optimizer="adam", **kw):
    """A two-layer Dense net and its ``ShardedTrainer`` on the CPU."""
    from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(8, activation="relu"))
    net.add(mx.gluon.nn.Dense(4))
    net.initialize(mx.init.Xavier(), ctx=CPU)
    net(batch(0)[0])
    rs = np.random.RandomState(seed)   # the same weights in every call
    for p in net.collect_params().values():
        p.set_data(mx.nd.array(
            (rs.randn(*p.shape) * 0.3).astype(np.float32), ctx=CPU))
    return net, ShardedTrainer(net, mx.gluon.loss.L2Loss(), optimizer,
                               {"learning_rate": 0.05},
                               mesh=DeviceMesh({"dp": 1}, devices=[CPU]),
                               **kw)


def params_of(net):
    return {k: p.data().asnumpy().copy()
            for k, p in net.collect_params().items()}


def join_waiters(point, timeout=10.0):
    """Wait for the watchdog's abandoned waiter threads of ``point``."""
    for t in threading.enumerate():
        if t.name == f"mxtpu-waiter-{point}":
            t.join(timeout)
