"""Fault C10 (ROADMAP.md): a dropped trainer, hybridized block or
executor must be freed, with its compiled entries (on a card, its CUDA
graphs and their memory pools), as soon as its last reference goes,
without Python's cyclic collector. Each owner holds its
``compile.jit`` functions; those hold the owner's bound methods weakly.
Checked here on the CPU with the collector off; the card's memory
returning is ``tests/test_torch_card.py::
test_c10_a_dropped_captured_trainer_returns_its_pool_on_card``."""
import gc
import weakref

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import compile as compile_service
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

CPU = mx.cpu()


@pytest.fixture
def no_collector():
    # torch.utils.checkpoint's first call imports torch._dynamo, and that
    # import keeps the frames of the call that triggered it (once per
    # process): make it here, not in a trainer's step
    torch.utils.checkpoint.checkpoint(
        lambda t: t * 2, torch.ones(1, requires_grad=True),
        use_reentrant=False)
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def _x(*shape):
    return mx.nd.array(np.random.RandomState(0).randn(*shape).astype(
        np.float32), ctx=CPU)


def _net():
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(8, activation="relu"), mx.gluon.nn.Dense(4))
    net.initialize(ctx=CPU)
    return net


def _gone(ref, what):
    assert ref() is None, (what, [type(r).__name__
                                  for r in gc.get_referrers(ref())])


def test_a_dropped_hybridized_block_is_freed(no_collector):
    with CPU:
        net = _net()
        net.hybridize()
        x = _x(2, 3)
        net(x)
        net(x)
        with mx.autograd.record():
            net(x).sum().backward()
        op = weakref.ref(net._cached_op)
        block = weakref.ref(net)
        registered = len(compile_service.registered())
        del net
    _gone(block, "block")
    _gone(op, "CachedOp")
    assert len(compile_service.registered()) == registered - 2


def test_a_dropped_trainer_is_freed_and_its_net_lives_on(no_collector):
    with CPU:
        net = _net()
        net(_x(2, 3))
        for kw in ({}, {"remat": True, "accum_steps": 2}):
            st = ShardedTrainer(net, mx.gluon.loss.L2Loss(), "adam",
                                {"learning_rate": 0.01},
                                mesh=DeviceMesh({"dp": 1}, devices=[CPU]),
                                **kw)
            st.step(_x(4, 3), _x(4, 4))
            st.predict(_x(4, 3))
            ref = weakref.ref(st)
            fn = st._step_fn
            del st
            _gone(ref, "trainer")
            with pytest.raises(mx.MXNetError, match="is gone"):
                fn(_x(4, 3)._data, _x(4, 4)._data)
        assert net(_x(2, 3)).shape == (2, 4)


def test_a_dropped_executor_is_freed(no_collector):
    data = mx.sym.var("data")
    out = mx.sym.FullyConnected(mx.sym.Activation(
        mx.sym.FullyConnected(data, num_hidden=6, name="fc1"),
        act_type="relu"), num_hidden=2, name="fc2")
    ex = out.simple_bind(CPU, data=(3, 5))
    ex.forward(is_train=True, data=_x(3, 5))
    ex.backward(_x(3, 2))
    ex.forward(is_train=False, data=_x(3, 5))
    ref = weakref.ref(ex)
    del ex
    _gone(ref, "executor")


def test_a_dropped_module_frees_its_executor(no_collector):
    data = mx.sym.var("data")
    sym = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        data, num_hidden=3, name="fc"), name="softmax")
    mod = mx.mod.Module(sym, context=CPU)
    mod.bind(data_shapes=[("data", (4, 5))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params()
    ex = weakref.ref(mod._exec)
    del mod
    _gone(ex, "the module's executor")
