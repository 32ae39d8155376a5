"""The port's compile service (``compile.jit``) and ``CachedOp``
(``hybridize()``) on the CPU, against the JAX package's where both
compute: a hybridized BERT-class classifier (chip_smoke.build_classifier:
2 encoder cells, 64 units) and a hybridized thumbnail resnet18_v1, each
with the JAX block's weights (``convert.load_jax_params``).

On the CPU an entry is a plain call, so these tests hold what does not
need a card: the keys (input signature, static arguments, parameter
data pointers), the statistics, ``set_enabled``, re-keying on a rebind,
a ``cast`` and a ``substitute``, one entry per input signature through
rounds of training and evaluation, an unhashable static argument, in-place
writes seen without a new entry, recording and training-mode calls
making their own entries (the forward/backward pair) with the
unhybridized block's gradients, results never aliased by a later call,
the launch-count
record that replays add, and the not-ported disk cache raising. The
graphs themselves are held against the eager forward on the card
(``tests/test_torch_card.py``, ``chip_smoke.py``'s capture phase)."""
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import build_classifier, random_params
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch import compile as mxc
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.parameter import substitute

SMALL = {"vocab": 128, "units": 64, "hidden": 128, "heads": 4, "layers": 2,
         "seq_len": 16, "num_classes": 2}
CPU = mx.cpu()
# float32 logits through two encoder cells, two frameworks on the CPU
# (tests/test_torch_serving.py's tolerance)
RTOL = ATOL = 1e-4
# eval-mode resnet logits, XLA's convolutions against oneDNN's, relative
# to the largest logit (tests/test_torch_model_zoo.py's EVAL_TOL)
RESNET_TOL = 1e-5


def _tokens(n, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, SMALL["vocab"], (n, SMALL["seq_len"])).astype(
        np.float32)


def _site(site="cachedop", package=mxc):
    return dict(package.stats().get(site, {"hits": 0, "misses": 0}))


def _moved(before, after):
    return (after["misses"] - before["misses"],
            after["hits"] - before["hits"])


@pytest.fixture
def clf():
    weights = random_params(SMALL, seed=0)
    net = build_classifier(mx, SMALL)
    net.initialize(ctx=CPU)
    load_jax_params(net, weights)
    return net, weights


@pytest.fixture
def eager():
    """Call ``fn`` with the service off (the explicit eager route)."""
    def run(fn, *args):
        prev = mxc.set_enabled(False)
        try:
            return fn(*args)
        finally:
            mxc.set_enabled(prev)
    return run


def _mlp(seed=0):
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu"), nn.Dense(3))
    net.initialize(ctx=CPU)
    net(mx.nd.array(np.zeros((1, 5), np.float32), ctx=CPU))
    rs = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(rs.randn(*p.shape).astype(np.float32))
    return net


def _x(n=4, seed=1):
    return mx.nd.array(np.random.RandomState(seed).randn(n, 5).astype(
        np.float32), ctx=CPU)


def test_hybridized_classifier_matches_the_jax_package(clf):
    """One entry per input signature in both packages: three calls at two
    batch sizes make two misses and one hit, the hybridized children
    (encoder cells, Dense layers) running inside the parent's entry."""
    net, weights = clf
    jnet = build_classifier(jmx, SMALL)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(_tokens(2, seed=0)))
    for name, p in jnet._collect_params_with_structure().items():
        p.set_data(jmx.nd.array(weights[name]))
    jnet.hybridize()
    net.hybridize()
    mine, theirs = _site(), _site(package=jmx.compile)
    for n, seed in ((3, 1), (3, 2), (5, 3)):
        x = _tokens(n, seed)
        want = jnet(jmx.nd.array(x)).asnumpy()
        got = net(mx.nd.array(x, ctx=CPU)).asnumpy()
        assert got.shape == (n, SMALL["num_classes"])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert _moved(mine, _site()) == (2, 1)
    assert _moved(theirs, _site(package=jmx.compile))[0] == 2


def test_hybridized_resnet18_thumbnail_matches_the_jax_package():
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32)
    jnet = jvision.get_model("resnet18_v1", classes=10)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    net = vision.get_model("resnet18_v1", classes=10)
    net.initialize(ctx=CPU)
    load_jax_params(net, {n: p.data().asnumpy() for n, p in
                          jnet._collect_params_with_structure().items()})
    jnet.hybridize(static_alloc=True, static_shape=True)
    net.hybridize(static_alloc=True, static_shape=True)
    want = jnet(jmx.nd.array(x)).asnumpy()
    before = _site()
    first = net(mx.nd.array(x, ctx=CPU)).asnumpy()
    second = net(mx.nd.array(x, ctx=CPU)).asnumpy()
    assert _moved(before, _site()) == (1, 1)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(first, want, rtol=RESNET_TOL,
                               atol=RESNET_TOL * scale)
    np.testing.assert_array_equal(first, second)


def test_first_call_with_deferred_shapes_runs_eagerly():
    """The whole first call runs eagerly: a child without parameters
    (the Activation) makes no entry of its own in it."""
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8), nn.Activation("relu"), nn.Dense(3))
    net.initialize(ctx=CPU)
    net.hybridize()
    x = _x()
    before = _site()
    y0 = net(x).asnumpy()  # resolves in_units: eager, no entry
    assert _moved(before, _site()) == (0, 0)
    y1 = net(x).asnumpy()
    y2 = net(x).asnumpy()
    assert _moved(before, _site()) == (1, 1)
    np.testing.assert_array_equal(y0, y1)
    np.testing.assert_array_equal(y1, y2)


def test_set_enabled_false_runs_eagerly_and_counts_nothing(eager):
    net = _mlp()
    net.hybridize()
    x = _x()
    want = net(x).asnumpy()
    assert mxc.enabled()
    before = _site()
    got = eager(net, x).asnumpy()
    assert _moved(before, _site()) == (0, 0)
    np.testing.assert_array_equal(got, want)
    assert mxc.set_enabled(True) is True


def test_set_data_rebinds_and_captures_anew(eager):
    net = _mlp()
    net.hybridize()
    x = _x()
    y0 = net(x).asnumpy()
    w = net[1].weight
    before = _site()
    w.set_data(w.data().asnumpy() * 2.0)
    y1 = net(x).asnumpy()
    assert _moved(before, _site()) == (1, 0)
    assert not np.array_equal(y0, y1)
    np.testing.assert_array_equal(y1, eager(net, x).asnumpy())


def test_in_place_writes_are_read_without_a_new_entry(eager):
    net = _mlp()
    net.hybridize()
    x = _x()
    y0 = net(x).asnumpy()
    before = _site()
    with torch.no_grad():
        net[0].weight.data()._data.mul_(0.5)
    y1 = net(x).asnumpy()
    assert _moved(before, _site()) == (0, 1)
    assert not np.array_equal(y0, y1)
    np.testing.assert_array_equal(y1, eager(net, x).asnumpy())


def test_cast_drops_the_cached_op_and_captures_in_the_new_dtype(eager):
    net = _mlp()
    net.hybridize()
    x = _x()
    net(x)
    op = net._cached_op
    before = _site()
    net.cast("bfloat16")
    assert net._cached_op is None and net[0]._cached_op is None
    xb = x.astype("bfloat16")
    y = net(xb)
    assert net._cached_op is not op
    assert _moved(before, _site()) == (1, 0)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y._data, eager(net, xb)._data)


def test_substitute_is_seen_by_the_key(eager):
    """``ServedModel.from_block`` runs a block on its snapshot through
    ``substitute``: the key reads the substituted tensors."""
    net = _mlp()
    net.hybridize()
    x = _x()
    y0 = net(x).asnumpy()
    snap = {p: mx.nd.array(p.data().asnumpy() * 0.5, ctx=CPU)
            for p in net.collect_params().values()}
    before = _site()
    with substitute(snap):
        y1 = net(x).asnumpy()
        want = eager(net, x).asnumpy()
    assert _moved(before, _site()) == (1, 0)
    np.testing.assert_array_equal(y1, want)
    assert not np.array_equal(y0, y1)
    # one entry per input signature: back on the live parameters, the
    # entry is built anew in place of the substituted one
    np.testing.assert_array_equal(net(x).asnumpy(), y0)
    assert _moved(before, _site()) == (2, 0)
    assert len(net._cached_op.stats()["entries"]) == 1


def test_recording_and_training_calls_stay_eager_with_gradients():
    """A recording call of a hybridized block makes a ``cachedop`` entry
    (the pair of its forward and backward: a miss, then hits), and so
    does a training-mode call (its own signature); the gradients equal
    the unhybridized block's, for ``grad_req`` "write" and "add". (The
    name is older than the training capture: on the CPU an entry is
    still a plain, eager call.)"""
    net = _mlp()
    x = _x()
    grads = {}
    for req in ("write", "add"):
        for p in net.collect_params().values():
            p.grad_req = req
        for active in (False, True):
            net.hybridize(active)
            net(x)  # an inference call: an entry when hybridized
            net.collect_params().zero_grad()
            before = _site()
            for _ in range(2):
                with mx.autograd.record():
                    loss = (net(x) * net(x)).sum()
                loss.backward()
            with mx.autograd.train_mode():
                net(x)
            moved = _moved(before, _site())
            if active:
                assert moved == (2, 3)
                assert {e["kind"] for e in
                        net._cached_op.stats()["entries"]} == {"plain"}
            else:
                assert moved == (0, 0)
            grads[req, active] = {n: p.grad().asnumpy().copy()
                                  for n, p in net.collect_params().items()}
    for req in ("write", "add"):
        assert grads[req, False].keys() == grads[req, True].keys()
        for name, want in grads[req, False].items():
            assert np.abs(want).max() > 0, name
            np.testing.assert_array_equal(grads[req, True][name], want,
                                          err_msg=f"{req} {name}")
    for name, want in grads["write", False].items():
        np.testing.assert_allclose(grads["add", False][name], 2 * want,
                                   rtol=1e-6, err_msg=name)


def test_train_then_evaluate_keeps_one_entry_per_signature(eager):
    """BatchNorm's training forward writes its running statistics in
    place (``update_state``), so the evaluations after it keep their
    entries and read the latest statistics: rounds of training and
    evaluation at two input signatures leave three entries (the two
    inference signatures and the training pair), each made once."""
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(8), nn.BatchNorm(), nn.Dense(3))
    net.initialize(ctx=CPU)
    net.hybridize()
    x, x6 = _x(), _x(n=6, seed=3)
    net(x)  # resolves the deferred shapes eagerly
    net(x)
    op = net._cached_op
    before, outs = _site(), []
    rounds = 4
    for i in range(rounds):
        with mx.autograd.record():
            loss = net(_x(seed=10 + i)).sum()
        loss.backward()
        y = net(x)
        net(x6)
        assert torch.equal(y._data, eager(net, x)._data)
        outs.append(y.asnumpy())
    assert net._cached_op is op
    assert _moved(before, _site()) == (2, 3 * rounds - 2)
    assert len(op.stats()["entries"]) == 3
    assert not np.array_equal(outs[0], outs[-1])


class _Scaled(nn.HybridBlock):
    def hybrid_forward(self, F, x, weights):
        return x * float(weights.sum())


def test_an_unhashable_static_argument_reaches_the_forward():
    """A numpy array as a static argument: keyed by its ``repr``, handed
    to the forward as it is."""
    net = _Scaled()
    net.hybridize()
    x = _x()
    before = _site()
    for w, k in ((np.array([1.0, 2.0]), 3.0), (np.array([1.0, 2.0]), 3.0),
                 (np.array([1.0, 3.0]), 4.0)):
        np.testing.assert_array_equal(net(x, w).asnumpy(), x.asnumpy() * k)
    assert _moved(before, _site()) == (2, 1)


def test_earlier_results_are_not_aliased_by_later_calls():
    net = _mlp()
    net.hybridize()
    a = net(_x(seed=1))
    kept = a.asnumpy().copy()
    b = net(_x(seed=2))
    assert a._data.data_ptr() != b._data.data_ptr()
    np.testing.assert_array_equal(a.asnumpy(), kept)
    assert not np.array_equal(a.asnumpy(), b.asnumpy())


def test_jit_keys_on_structure_static_values_and_reads():
    w = torch.ones(3)
    state = {"w": w}

    def fn(d, scale):
        return {"y": d["a"] * scale + state["w"], "z": [d["b"][0] * 2]}

    f = mxc.jit(fn, site="test_jit", token=("fn",),
                reads=lambda: [state["w"]])
    args = {"a": torch.arange(3.0), "b": [torch.ones(2)]}
    out = f(args, 2.0)
    assert torch.equal(out["y"], torch.tensor([1.0, 3.0, 5.0]))
    assert torch.equal(out["z"][0], torch.full((2,), 2.0))
    f(args, 2.0)
    f(args, 3.0)                                   # a static value
    f({"a": torch.arange(3.0), "b": [torch.ones(4)]}, 2.0)  # a shape
    state["w"] = torch.zeros(3)                    # a rebound read
    assert torch.equal(f(args, 2.0)["y"], torch.tensor([0.0, 2.0, 4.0]))
    st = mxc.stats()["test_jit"]
    assert (st["misses"], st["hits"], st["compiles"]) == (4, 1, 4)
    assert st["captures"] == st["replays"] == 0 and st["capture_ms"] == 0
    own = f.stats()
    # the rebound read replaced the entry of its argument signature
    assert own["misses"] == 4 and [e["kind"] for e in own["entries"]] == \
        ["plain"] * 3
    assert [e["shapes"] for e in own["entries"]] == [
        [(3,), (2,)], [(3,), (4,)], [(3,), (2,)]]


def test_stats_totals_reset_registry_and_clear_memory():
    f = mxc.jit(lambda t: t + 1, site="test_stats", token=("stats",))
    t = torch.zeros(2)
    f(t)
    f(t)
    assert any(site == "test_stats" for site in mxc.registered().values())
    tot = mxc.totals()
    assert tot["hits"] >= 1 and tot["misses"] >= 1
    mxc.reset_stats()
    assert "test_stats" not in mxc.stats()
    f(t)  # the live function counts into the zeroed list
    assert mxc.stats()["test_stats"]["hits"] == 1
    mxc.clear_memory()
    f(t)
    assert mxc.stats()["test_stats"]["misses"] == 1


@pytest.mark.parametrize("name,args", [
    ("configure", ()), ("fingerprint", ()), ("warmup", ()),
    ("manifest", ()), ("save_manifest", ("x.json",)),
    ("clear_manifest", ()), ("last_warmup", ()), ("disk_report", ()),
    ("gc_cache", ())])
def test_the_disk_cache_and_manifest_are_not_ported(name, args):
    with pytest.raises(mx.MXNetError, match="does not serialize"):
        getattr(mxc, name)(*args)
    assert mxc.cache_dir() is None


def test_replays_add_what_the_capture_recorded():
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.launches_by_path = {"fast": 0}
    with kernels.recording() as record:
        kernels.count(wrapper)
        kernels.count(wrapper, "launches_by_path", "fast", 2)
    assert wrapper.launches == 0 and wrapper.launches_by_path["fast"] == 0
    assert record == {(wrapper, "launches", None): 1,
                      (wrapper, "launches_by_path", "fast"): 2}
    for _ in range(3):
        kernels.add_counts(record)
    assert wrapper.launches == 3 and wrapper.launches_by_path["fast"] == 6


def test_counts_from_many_threads_are_not_lost():
    """Runner threads of several models count at once: 16 threads (more
    than this machine's cores), a short switch interval, and every
    statistic and kernel counter equal to the calls made."""
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.launches_by_path = {"fast": 0}
    record = {(wrapper, "launches", None): 1,
              (wrapper, "launches_by_path", "fast"): 2}
    fns = [mxc.jit(lambda t: t * 2, site="test_threads", token=("t", i))
           for i in range(4)]
    t = torch.ones(3)
    threads, calls = 16, 200
    done = []

    def work(i):
        fn = fns[i % len(fns)]
        for _ in range(calls):
            fn(t)
            kernels.count(wrapper)
            kernels.add_counts(record)
        done.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,))
                for i in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in pool) and len(done) == threads
    st = mxc.stats()["test_threads"]
    assert st["misses"] == len(fns)
    assert st["hits"] + st["misses"] == threads * calls
    assert sum(fn.stats()["hits"] + fn.stats()["misses"] for fn in fns) \
        == threads * calls
    assert wrapper.launches == 2 * threads * calls
    assert wrapper.launches_by_path["fast"] == 2 * threads * calls


def test_a_capture_failure_names_the_op():
    """What ``CaptureError`` reports: the innermost registered op of the
    exception's traceback (here raised on the CPU, where nothing is
    captured)."""
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Activation("relu"))
    net.initialize(ctx=CPU)
    net[0]._act_type = "nope"
    net.hybridize()
    with pytest.raises(ValueError) as info:
        net(_x())
    where = mxc._where(info.value)
    assert where.startswith("op 'Activation' (mxnet_tpu_torch/ops/nn.py:")
    assert issubclass(mxc.CaptureError, mx.MXNetError)
