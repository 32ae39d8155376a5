"""Training capture on the CPU: the compile service's sites ``trainer``
(``ShardedTrainer``'s step and ``predict``, graph entries),
``executor`` (``Module``'s training pair and inference forward) and the
``cachedop`` pair of a hybridized block under ``autograd.record()``.

On the CPU an entry is a plain call of the same function a card
captures, so these tests hold what needs no card: the keys, misses, hits
and ``stats()``; one entry per batch signature; a new entry after
``load_states`` or a rebinding ``cast``; ``set_enabled(False)`` counting
nothing; the jitted step against the eager one bit for bit and against
the JAX ``ShardedTrainer`` (``tests/test_torch_train.py``'s and
``tests/test_torch_resnet_train.py``'s tolerances); BatchNorm's
running statistics written in place, equal to the JAX package's and
restored in place after a NaN batch; a hybridized block's gradients
under ``record()`` against the unhybridized block's and the JAX
package's hybridized block, for ``grad_req`` "write" and "add"; and
``Module.fit`` through the executor site bit for bit against
``set_enabled(False)``. The graphs themselves are held on the card
(``tests/test_torch_card.py``, ``chip_smoke.py``'s train_capture,
ResNet-50, gluon_hybrid_train and dropout_capture phases)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import build_classifier, random_params
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.parallel import DeviceMesh as JaxMesh
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu_torch import compile as mxc
from mxnet_tpu_torch.convert import export_params, load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

CPU = mx.cpu()
# the 2-layer classifier at width 64
SMALL = {"vocab": 128, "units": 64, "hidden": 128, "heads": 4, "layers": 2,
         "seq_len": 16, "num_classes": 2}
BATCH, STEPS = 8, 3
OPTIMIZERS = {
    "adam": {"learning_rate": 1e-3, "wd": 1e-4},
    "sgd": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
}
# tests/test_torch_train.py: the loss to rtol 1e-5; each parameter within
# 1e-2 lr (the attention key biases, whose true gradient is zero, 1 lr
# under Adam)
LOSS_RTOL = 1e-5
# tests/test_torch_resnet_train.py: the running statistics to 1e-5 of
# their largest magnitude; each weight and momentum within 5% of the L2
# norm of the JAX step for that tensor, from one synchronised state
AUX_TOL, UPDATE_TOL = 1e-5, 0.05
RESNET_HYPER = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
# float32 gradients through two encoder cells, two frameworks on the
# CPU, relative to each tensor's largest gradient; the attention key
# biases, whose true gradient is zero (tests/test_torch_train.py says
# why), relative to the largest gradient of any tensor
GRAD_TOL = 1e-4


def _site(site):
    return dict(mxc.stats().get(site, {"hits": 0, "misses": 0}))


def _moved(site, before):
    after = _site(site)
    return (after["misses"] - before["misses"],
            after["hits"] - before["hits"])


def _task(n, seed=5):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, SMALL["vocab"], (n, SMALL["seq_len"])).astype(
        np.float32)
    y = rs.randint(0, SMALL["num_classes"], n).astype(np.float32)
    return x, y


def _classifier(weights):
    clf = build_classifier(mx, SMALL)
    clf.initialize(ctx=CPU)
    load_jax_params(clf, weights)
    return clf


def _trainer(optimizer="adam", weights=None, **kw):
    clf = _classifier(weights or random_params(SMALL, seed=0))
    st = ShardedTrainer(clf, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                        optimizer, dict(OPTIMIZERS[optimizer]),
                        mesh=DeviceMesh({"dp": 1}, devices=[CPU]), **kw)
    return clf, st


def _nd(a):
    return mx.nd.array(a, ctx=CPU)


def _state(st):
    return [t.clone() for t in st._state_tensors().values()]


# ---- site "trainer": keys and statistics ----------------------------------

def test_the_trainer_site_keys_its_steps_and_predict():
    """One entry per batch signature (a miss, then hits), ``predict`` a
    second function under the same site, and ``set_enabled(False)``
    counting nothing."""
    _, st = _trainer()
    x, y = _task(BATCH + 4)
    before = _site("trainer")
    for _ in range(3):
        st.step(_nd(x[:BATCH]), _nd(y[:BATCH]))
    assert _moved("trainer", before) == (1, 2)
    st.step(_nd(x[:4]), _nd(y[:4]))          # a new batch signature
    st.step(_nd(x[4:8]), _nd(y[4:8]))
    assert _moved("trainer", before) == (2, 3)
    own = st._step_fn.stats()
    assert (own["misses"], own["hits"], own["compiles"]) == (2, 3, 2)
    assert own["captures"] == own["replays"] == 0
    assert [e["kind"] for e in own["entries"]] == ["plain", "plain"]
    assert [e["shapes"] for e in own["entries"]] == [
        [(BATCH, SMALL["seq_len"]), (BATCH,)], [(4, SMALL["seq_len"]), (4,)]]
    st.predict(_nd(x[:BATCH]))
    st.predict(_nd(x[:BATCH]))
    assert _moved("trainer", before) == (3, 4)
    assert st._predict_fn.stats()["misses"] == 1
    assert sorted(site for site in mxc.registered().values()
                  if site == "trainer")[:2] == ["trainer", "trainer"]
    prev = mxc.set_enabled(False)
    try:
        st.step(_nd(x[:BATCH]), _nd(y[:BATCH]))
        st.predict(_nd(x[:BATCH]))
    finally:
        mxc.set_enabled(prev)
    assert _moved("trainer", before) == (3, 4)
    assert st._t == 6


def test_load_states_and_a_rebinding_cast_make_a_new_entry(tmp_path):
    """``load_states`` drops the step's entries; a ``cast`` that rebinds
    the weights (here to bfloat16 and back, which keeps the routes)
    changes the reads' pointers: each next step is a miss, and the step
    after it a hit."""
    clf, st = _trainer()
    x, y = _task(BATCH)
    xb, yb = _nd(x), _nd(y)
    st.step(xb, yb)
    st.step(xb, yb)
    path = str(tmp_path / "st.states")
    st.save_states(path)
    before = _site("trainer")
    st.load_states(path)
    st.step(xb, yb)
    st.step(xb, yb)
    assert _moved("trainer", before) == (1, 1)
    ptrs = [h._data.data_ptr() for h in st._train_handles]
    clf.cast("bfloat16")
    clf.cast("float32")
    assert [h._data.data_ptr() for h in st._train_handles] != ptrs
    assert all(h._data.dtype == torch.float32 for h in st._train_handles)
    st.step(xb, yb)
    st.step(xb, yb)
    assert _moved("trainer", before) == (2, 2)
    assert len(st._step_fn.stats()["entries"]) == 1


# ---- the jitted step against the eager step and the JAX trainer -----------

@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_jitted_classifier_steps_are_the_eager_steps_bit_for_bit(optimizer):
    weights = random_params(SMALL, seed=0)
    x, y = _task(BATCH * STEPS)
    runs = {}
    for mode in ("jitted", "eager"):
        _, st = _trainer(optimizer, weights)
        prev = mxc.set_enabled(mode == "jitted")
        try:
            losses = [st.step(_nd(x[i * BATCH:(i + 1) * BATCH]),
                              _nd(y[i * BATCH:(i + 1) * BATCH]))._data
                      for i in range(STEPS)]
        finally:
            mxc.set_enabled(prev)
        runs[mode] = (losses, _state(st), st._t)
    assert runs["jitted"][2] == runs["eager"][2] == STEPS
    for a, b in zip(runs["jitted"][0], runs["eager"][0]):
        assert torch.equal(a, b)
    for a, b in zip(runs["jitted"][1], runs["eager"][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_jitted_classifier_steps_match_the_jax_trainer(optimizer):
    """``tests/test_torch_train.py``'s parity, through the jitted step."""
    params = OPTIMIZERS[optimizer]
    weights = random_params(SMALL, seed=0)
    x, y = _task(BATCH * STEPS)
    clf, st = _trainer(optimizer, weights)
    jclf = build_classifier(jmx, SMALL)
    jclf.initialize(jmx.init.Xavier())
    jclf(jmx.nd.array(x[:2]))
    for name, p in jclf._collect_params_with_structure().items():
        p.set_data(jmx.nd.array(weights[name]))
    jst = JaxTrainer(jclf, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                     optimizer, dict(params), mesh=JaxMesh({"dp": 1}))
    before = _site("trainer")
    for i in range(STEPS):
        xb, yb = x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH]
        got = st.step(_nd(xb), _nd(yb)).asscalar()
        want = jst.step(jmx.nd.array(xb), jmx.nd.array(yb)).asscalar()
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert _moved("trainer", before) == (1, STEPS - 1)
    got = export_params(clf)
    lr = params["learning_rate"]
    for name, p in jclf._collect_params_with_structure().items():
        noise = optimizer == "adam" and name.endswith("attn.key.bias")
        np.testing.assert_allclose(got[name], p.data().asnumpy(), rtol=0,
                                   atol=(1.0 if noise else 1e-2) * lr,
                                   err_msg=name)


def _host(raw):
    return np.array(raw, dtype=np.float32)


def _resnet_pair(nan_guard):
    """A thumbnail resnet18_v1 in both packages from the JAX package's
    Xavier draw (``tests/test_torch_resnet_train.py``'s pair)."""
    rs = np.random.RandomState(0)
    x = rs.rand(STEPS, BATCH, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, (STEPS, BATCH)).astype(np.float32)
    jmx.random.seed(0)
    jnet = jvision.get_model("resnet18_v1", classes=10, thumbnail=True,
                             prefix="capthumb_")
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x[0]))
    net = vision.get_model("resnet18_v1", classes=10, thumbnail=True,
                           prefix="capthumb_")
    net.initialize(ctx=CPU)
    load_jax_params(net, {n: p.data().asnumpy() for n, p in
                          jnet._collect_params_with_structure().items()})
    jst = JaxTrainer(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     dict(RESNET_HYPER), mesh=JaxMesh({"dp": 1}),
                     nan_guard=nan_guard)
    st = ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                        dict(RESNET_HYPER),
                        mesh=DeviceMesh({"dp": 1}, devices=[CPU]),
                        nan_guard=nan_guard)
    return jst, st, x, y


def _sync_in_place(st, jst):
    """The JAX trainer's weights, momenta and statistics copied into the
    port's tensors (in place: the step's entry stays)."""
    for h, jh in zip(st._train_handles + st._aux_handles,
                     jst._train_handles + jst._aux_handles):
        h._data.copy_(torch.from_numpy(_host(jh._data)))
    for per, jper in zip(st._opt_state, jst._opt_raws):
        for s, js in zip(per, jper):
            s.copy_(torch.from_numpy(_host(js)))


@pytest.mark.parametrize("nan_guard", [True, False])
def test_jitted_resnet_steps_keep_statistics_in_place_and_match_jax(
        nan_guard):
    """Three jitted steps of the thumbnail, each from the JAX trainer's
    state: the running statistics keep their storage and equal the JAX
    package's, every weight and momentum within 5% of the JAX step's L2
    norm; then the same three steps eagerly from the same states, bit
    for bit the jitted ones."""
    jst, st, x, y = _resnet_pair(nan_guard)
    ptrs = [h._data.data_ptr() for h in st._aux_handles]
    before = _site("trainer")
    states, jitted = [], []
    for i in range(STEPS):
        _sync_in_place(st, jst)
        states.append(_state(st))
        want = jst.step(jmx.nd.array(x[i]), jmx.nd.array(y[i])).asscalar()
        got = st.step(_nd(x[i]), _nd(y[i])).asscalar()
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        assert [h._data.data_ptr() for h in st._aux_handles] == ptrs
        for h, jh in zip(st._aux_handles, jst._aux_handles):
            ref = _host(jh._data)
            np.testing.assert_allclose(
                h._data.numpy(), ref, rtol=AUX_TOL,
                atol=AUX_TOL * max(float(np.abs(ref).max()), 1.0))
        moms = [_host(per[0]) for per in jst._opt_raws]
        for got_t, want_t in (
                ([h._data.numpy() for h in st._train_handles],
                 [_host(h._data) for h in jst._train_handles]),
                ([per[0].numpy() for per in st._opt_state], moms)):
            errs = [float(np.linalg.norm(g - w) / max(np.linalg.norm(s),
                                                      1e-30))
                    for g, w, s in zip(got_t, want_t, moms)]
            assert max(errs) <= UPDATE_TOL, (i, max(errs))
        jitted.append((got, _state(st)))
    assert _moved("trainer", before) == (1, STEPS - 1)
    prev = mxc.set_enabled(False)
    try:
        for i in range(STEPS):
            for t, v in zip(st._state_tensors().values(), states[i]):
                t.copy_(v)
            loss = st.step(_nd(x[i]), _nd(y[i])).asscalar()
            assert loss == jitted[i][0]
            assert all(torch.equal(a, b) for a, b in
                       zip(_state(st), jitted[i][1]))
    finally:
        mxc.set_enabled(prev)


def test_a_nan_batch_restores_the_statistics_in_place():
    """A jitted step on a batch holding a NaN: the weights, momenta and
    running statistics equal their values before it, in the same
    storage, as the JAX trainer's do; the next good step moves them."""
    jst, st, x, y = _resnet_pair(True)
    st.step(_nd(x[0]), _nd(y[0]))
    st.step(_nd(x[1]), _nd(y[1]))
    tensors = st._train_handles + st._aux_handles
    ptrs = [h._data.data_ptr() for h in tensors]
    before = _state(st)
    bad = x[2].copy()
    bad[3, 1, 5, 7] = np.nan
    loss = st.step(_nd(bad), _nd(y[2]))
    assert np.isnan(loss.asscalar()) and st.skipped_steps == 1
    assert [h._data.data_ptr() for h in tensors] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(before, _state(st)))
    jst.step(jmx.nd.array(x[0]), jmx.nd.array(y[0]))
    jaux = [_host(h._data) for h in jst._aux_handles]
    jst.step(jmx.nd.array(bad), jmx.nd.array(y[2]))
    assert jst.skipped_steps == 1 and all(
        np.array_equal(a, _host(h._data))
        for a, h in zip(jaux, jst._aux_handles))
    st.step(_nd(x[0]), _nd(y[0]))
    assert not torch.equal(before[len(st._train_handles)],
                           st._aux_handles[0]._data)


# ---- site "cachedop": a hybridized block under record() -------------------

def _grads_of(net, x, y, req, rounds, mxp, loss_fn):
    for p in net.collect_params().values():
        if p.grad_req != "null":
            p.grad_req = req
    for p in net.collect_params().values():
        if p.grad_req != "null":
            p.zero_grad()
    for _ in range(rounds):
        with mxp.autograd.record():
            loss = loss_fn(net(x), y).mean()
        loss.backward()
    return {n: p.grad().asnumpy().copy()
            for n, p in net._collect_params_with_structure().items()
            if p.grad_req != "null"}


@pytest.mark.parametrize("req", ["write", "add"])
def test_hybridized_gradients_under_record_match_eager_and_jax(req):
    """The classifier hybridized, under ``record()``: its ``cachedop``
    pair (a miss, then hits) gives each parameter the gradient of the
    unhybridized block bit for bit, and the JAX package's hybridized
    block's within 1e-4 of the tensor's largest gradient; "add" sums two
    rounds."""
    weights = random_params(SMALL, seed=0)
    x, y = _task(BATCH)
    rounds = 2
    got = {}
    for active in (False, True):
        net = _classifier(weights)
        net.hybridize(active)
        net(_nd(x))   # resolve deferred shapes; an inference entry
        before = _site("cachedop")
        got[active] = _grads_of(net, _nd(x), _nd(y), req, rounds, mx,
                                mx.gluon.loss.SoftmaxCrossEntropyLoss())
        assert _moved("cachedop", before) == \
            ((1, rounds - 1) if active else (0, 0))
    jnet = build_classifier(jmx, SMALL)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x[:2]))
    for name, p in jnet._collect_params_with_structure().items():
        p.set_data(jmx.nd.array(weights[name]))
    jnet.hybridize()
    want = _grads_of(jnet, jmx.nd.array(x), jmx.nd.array(y), req, rounds,
                     jmx, jmx.gluon.loss.SoftmaxCrossEntropyLoss())
    assert got[True].keys() == got[False].keys() == want.keys()
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_array_equal(got[True][name], got[False][name],
                                      err_msg=name)
        scale = top if name.endswith("attn.key.bias") else \
            float(np.abs(w).max())
        np.testing.assert_allclose(got[True][name], w, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=name)


# ---- site "executor": Module.fit -------------------------------------------

def _module_symbol():
    net = vision.get_model("resnet18_v1", classes=10, thumbnail=True,
                           prefix="capmod_")
    net.initialize(mx.init.Xavier(), ctx=CPU,
                   generator=torch.Generator().manual_seed(0))
    net(mx.nd.zeros((1, 3, 32, 32), ctx=CPU))
    return mx.sym.SoftmaxOutput(net(mx.sym.var("data")),
                                mx.sym.var("softmax_label"),
                                name="softmax")


def test_module_fit_through_the_executor_site_is_the_eager_fit():
    """Three ``Module.fit`` batches of the thumbnail through the jitted
    executor (one training pair: a miss, then hits; ``score`` one
    inference entry) and with ``set_enabled(False)`` from the same
    seed: the weights, momenta and statistics bit for bit."""
    rs = np.random.RandomState(0)
    xs = rs.rand(24, 3, 32, 32).astype(np.float32)
    ys = rs.randint(0, 10, 24).astype(np.float32)
    sym = _module_symbol()
    runs = {}
    for mode in ("jitted", "eager"):
        with CPU:
            it = mx.io.NDArrayIter(xs, ys, batch_size=8,
                                   label_name="softmax_label")
            mod = mx.mod.Module(sym, context=CPU)
            before = _site("executor")
            prev = mxc.set_enabled(mode == "jitted")
            try:
                mx.random.seed(0)
                mod.fit(it, num_epoch=1, optimizer="sgd",
                        optimizer_params={"learning_rate": 0.05,
                                          "momentum": 0.9, "wd": 1e-4},
                        initializer=mx.init.Xavier())
                acc = dict(mod.score(it, "acc"))["accuracy"]
            finally:
                mxc.set_enabled(prev)
        moved = _moved("executor", before)
        if mode == "jitted":
            assert moved == (2, 2 + 2)
            kinds = sorted(e["kind"] for e in (
                mod._exec._fwd_train.stats()["entries"]
                + mod._exec._fwd.stats()["entries"]))
            assert kinds == ["plain", "plain"]
        else:
            assert moved == (0, 0)
        arg, aux = mod.get_params()
        updater = mod._updater if mod._kvstore is None \
            else mod._kvstore._updater
        states = updater.states
        runs[mode] = (acc, {k: v._data.clone() for k, v in arg.items()},
                      {k: v._data.clone() for k, v in aux.items()},
                      {k: v._data.clone() for k, v in states.items()})
    assert runs["jitted"][0] == runs["eager"][0]
    for a, b in zip(runs["jitted"][1:], runs["eager"][1:]):
        assert a.keys() == b.keys() and a
        for k in a:
            assert torch.equal(a[k], b[k]), k


# ---- the service's keys and the pair's contract ---------------------------

@pytest.mark.parametrize("flag", ["cudnn.deterministic", "cudnn.benchmark",
                                  "cudnn.allow_tf32", "matmul.allow_tf32"])
def test_a_change_of_backend_flags_makes_the_entry_stale(flag):
    """The flags that choose the kernels a capture bakes in are part of an
    entry's key: a change makes the next call a miss that replaces the
    entry (one entry kept), and changing back does so again."""
    owner = torch.backends.cudnn if flag.startswith("cudnn") \
        else torch.backends.cuda.matmul
    attr = flag.split(".")[1]
    f = mxc.jit(lambda t: t * 2, site="test_flags", token=("flags", flag))
    t = torch.ones(3)
    before = _site("test_flags")
    f(t)
    f(t)
    old = getattr(owner, attr)
    setattr(owner, attr, not old)
    try:
        assert torch.equal(f(t), t * 2)
        f(t)
    finally:
        setattr(owner, attr, old)
    f(t)
    assert _moved("test_flags", before) == (3, 2)
    assert len(f.stats()["entries"]) == 1


class _StubPair:
    """What ``_PairFunction`` asks of a pair, replaying nothing: the
    forward doubles its input, the backward doubles the head gradient."""

    _what = "test[stub]"
    out_req = [True]

    def replay_forward(self, leaves):
        return [leaves[0].detach() * 2]

    def replay_backward(self, due, grads):
        due.done = True
        return (grads[0] * 2,)


def test_a_pair_is_differentiable_once():
    """A replayed pair's backward gives first-order gradients; with
    ``create_graph=True`` it raises, as the JAX package does for a
    hybridized node, rather than hand back gradients cut off from the
    graph."""
    from mxnet_tpu_torch.compile import _Due, _PairFunction

    x = torch.arange(3.0, requires_grad=True)
    due = _Due()
    (y,) = _PairFunction.apply(_StubPair(), due, 1, x)
    (g,) = torch.autograd.grad((y ** 2).sum(), [x])
    assert due.done and torch.equal(g, 8 * torch.arange(3.0))
    (y,) = _PairFunction.apply(_StubPair(), _Due(), 1, x)
    with pytest.raises(NotImplementedError, match="create_graph"):
        torch.autograd.grad((y ** 2).sum(), [x], create_graph=True)


def test_work_after_a_capture_is_deferred_to_its_record():
    """``kernels.after_capture`` files work in the record of the capture
    a launch goes into, and refuses (False) where there is none."""
    from mxnet_tpu_torch import kernels

    done = []
    assert kernels.after_capture(lambda: done.append(0)) is False
    with kernels.recording() as record:
        assert kernels.after_capture(lambda: done.append(1)) is True
    assert done == [] and len(record.after) == 1
    record.after[0]()
    assert done == [1]
