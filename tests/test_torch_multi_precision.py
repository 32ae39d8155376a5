"""Half-precision training with and without float32 master copies
(``multi_precision``), on the CPU against the JAX package.

Optimizer level: ``Optimizer``/``Updater`` and ``gluon.Trainer`` keep a
float32 master first in a half weight's state and update it with the
float32 gradient, then round it back into the weight (the JAX package's
``update_multi_precision``, ``mxnet_tpu/optimizer/optimizer.py:91-98``).
The masters equal the JAX package's float32 update within its own
rounding noise (1e-6, as ``test_torch_trainer.py`` holds float32) and
each weight is its master rounded. For float16 the JAX eager path is run
as it is. For bfloat16 it is not usable: ``str(weight.dtype)`` of a JAX
bfloat16 NDArray is ``"<class 'jax.numpy.bfloat16'>"``, so its eager
``create_state_multi_precision`` makes no master (fault C6 of
``ROADMAP.md``, kept in the reference and asserted below), and the
reference is that method's body, run on float32 copies.

Trainer level: ``ShardedTrainer`` on the three routes of
``parallel/opt_rules.py`` (float32 weights and masters through K1,
half-precision weights without masters through ``sgd_mom_update`` in
their type), each route's update against the JAX rule on identical
gradients (bit for bit on the float32 routes, one bfloat16 ulp on the
half route), and three steps of a thumbnail resnet18_v1 in bfloat16, with
and without ``multi_precision``, against the JAX ``ShardedTrainer``. Its
tolerance was measured: from one state (the port set to the JAX trainer's
weights, masters, momenta and running statistics before each step), one
bfloat16 step of either package differs from its own float32 step from
the same bfloat16-rounded weights by up to 52% (port) and 59% (JAX) of
that step's L2 norm in a tensor (median 33%, weight seeds 0-2; the
bfloat16 forward and backward round every activation and gradient, and
ReLU kinks turn the rounding into different gradients), and the two
packages' bfloat16 steps differ by up to 50% (median 33%). Float32 steps
of the two differ by at most 2.4% (``test_torch_resnet_train.py``). So
each master and momentum tensor is held to ``STEP_TOL`` = 75% of the L2
norm of the JAX step for it, the loss to 2e-2 (measured 6e-3; one
bfloat16 ulp is 2**-7 of a value) and the running statistics to 1e-2 of
their largest magnitude (measured 1.6e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.parallel import DeviceMesh as JaxMesh
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import opt_rules as jrules
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer, opt_rules

CPU = mx.cpu()
HYPER = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
OPTS = {"sgd": dict(learning_rate=0.05, momentum=0.9, wd=1e-3,
                    rescale_grad=0.5),
        "adam": dict(learning_rate=0.01, wd=1e-3, rescale_grad=0.5)}
SHAPES = [(16, 8), (33,), (4, 3, 3, 3), (7,)]
STEP_TOL, LOSS_RTOL, AUX_TOL = 0.75, 2e-2, 1e-2
F32_RTOL, F32_ATOL = 1e-6, 1e-7
HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
        "float16": (torch.float16, jnp.float16)}


def _host(r):
    r = getattr(r, "_data", r)
    if isinstance(r, torch.Tensor):
        return r.detach().float().numpy()
    return np.asarray(jnp.asarray(r).astype(jnp.float32))


def _weights(seed=0):
    rs = np.random.RandomState(seed)
    ws = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rs.randn(*s).astype(np.float32) for s in SHAPES]
          for _ in range(3)]
    return ws, gs


def _jax_mp_reference(name, dtype, dtypes, ws, gs):
    """The JAX package's ``update_multi_precision``: each half weight's
    float32 master updated by ``Optimizer.update`` with the gradient cast
    to float32, the weight its master rounded; the float32 weights
    updated as they are."""
    jdt = HALF[dtype][1]
    opt = jmx.optimizer.create(name, **OPTS[name])
    out = []
    for i, (w, dt) in enumerate(zip(ws, dtypes)):
        half = dt != "float32"
        w32 = jmx.nd.array(np.asarray(jnp.asarray(w).astype(jdt).astype(
            jnp.float32)) if half else w)
        st = opt.create_state(i, w32)
        for g in gs:
            g32 = jnp.asarray(g[i]).astype(jdt).astype(jnp.float32) \
                if half else jnp.asarray(g[i])
            opt.update(i, w32, jmx.nd.array(g32), st)
        out.append(_host(w32))
    return out


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("name", sorted(OPTS))
@pytest.mark.parametrize("batched", [False, True])
def test_updater_keeps_float32_masters_as_the_jax_package(name, dtype,
                                                          batched):
    ws, gs = _weights()
    dtypes = [dtype, "float32", dtype, "float32"]
    opt = mx.optimizer.create(name, multi_precision=True, **OPTS[name])
    upd = mx.optimizer.get_updater(opt)
    w = [mx.nd.array(a, ctx=CPU).astype(d) for a, d in zip(ws, dtypes)]
    for g in gs:
        grads = [mx.nd.array(a, ctx=CPU).astype(d)
                 for a, d in zip(g, dtypes)]
        if batched:
            upd.update_multi(list(range(len(w))), grads, w)
        else:
            for i in range(len(w)):
                upd(i, grads[i], w[i])
    want = _jax_mp_reference(name, dtype, dtypes, ws, gs)
    for i, (wi, dt) in enumerate(zip(w, dtypes)):
        st = upd.states[i]
        if dt == "float32":
            np.testing.assert_allclose(_host(wi), want[i], rtol=F32_RTOL,
                                       atol=F32_ATOL)
            continue
        master = st[0]._data
        assert master.dtype == torch.float32 and isinstance(st, tuple)
        np.testing.assert_allclose(master.numpy(), want[i], rtol=F32_RTOL,
                                   atol=F32_ATOL)
        assert torch.equal(wi._data, master.to(HALF[dtype][0]))
    if dtype == "float16":
        # the JAX package's own eager multi-precision engages for float16
        jopt = jmx.optimizer.create(name, multi_precision=True,
                                    **OPTS[name])
        jupd = jmx.optimizer.get_updater(jopt)
        jw = [jmx.nd.array(a).astype(d) for a, d in zip(ws, dtypes)]
        for g in gs:
            for i in range(len(jw)):
                jupd(i, jmx.nd.array(g[i]).astype(dtypes[i]), jw[i])
        for i, dt in enumerate(dtypes):
            if dt != "float32":
                np.testing.assert_allclose(
                    upd.states[i][0]._data.numpy(), _host(jupd.states[i][0]),
                    rtol=F32_RTOL, atol=F32_ATOL)


def test_c6_the_jax_eager_optimizer_makes_no_bfloat16_master():
    """Fault C6, kept in the reference: the JAX package's eager
    ``create_state_multi_precision`` compares ``str(weight.dtype)`` with
    ``"bfloat16"``, and a bfloat16 NDArray's dtype prints as a class, so
    no master is made; the port makes one, as the JAX ``ShardedTrainer``
    does."""
    jw = jmx.nd.array(np.ones((3, 2), np.float32)).astype("bfloat16")
    jopt = jmx.optimizer.SGD(momentum=0.9, multi_precision=True)
    assert str(jw.dtype) != "bfloat16"
    assert not isinstance(jopt.create_state_multi_precision(0, jw), tuple)
    w = mx.nd.array(np.ones((3, 2), np.float32), ctx=CPU).astype("bfloat16")
    st = mx.optimizer.SGD(momentum=0.9, multi_precision=True) \
        .create_state_multi_precision(0, w)
    assert isinstance(st, tuple) and st[0]._data.dtype == torch.float32


@pytest.mark.parametrize("name", sorted(OPTS))
def test_half_weights_without_masters_update_in_their_type(name):
    """No ``multi_precision``: the plain op in bfloat16 with lr and wd
    rounded to bfloat16, as the JAX package's fused step does; within one
    bfloat16 ulp of the JAX update (PyTorch rounds after each op, XLA
    once per fused chain)."""
    ws, gs = _weights(1)
    opt = mx.optimizer.create(name, **OPTS[name])
    jopt = jmx.optimizer.create(name, **OPTS[name])
    upd, jupd = mx.optimizer.get_updater(opt), jmx.optimizer.get_updater(jopt)
    w = [mx.nd.array(a, ctx=CPU).astype("bfloat16") for a in ws]
    jw = [jmx.nd.array(a).astype("bfloat16") for a in ws]
    for g in gs:
        upd.update_multi(list(range(len(w))),
                         [mx.nd.array(a, ctx=CPU).astype("bfloat16")
                          for a in g], w)
        jupd.update_multi(list(range(len(w))),
                          [jmx.nd.array(a).astype("bfloat16") for a in g],
                          jw)
    for a, b in zip(w, jw):
        assert a._data.dtype == torch.bfloat16
        ref = _host(b)
        np.testing.assert_allclose(_host(a), ref, rtol=2 ** -7,
                                   atol=2 ** -7 * float(np.abs(ref).max()))


def _dense_pair(pkg, ws, **ctx):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(16, in_units=8, activation="relu"),
                pkg.gluon.nn.Dense(4, in_units=16))
    net.initialize(**ctx)
    for p, a in zip(net.collect_params().values(), ws):
        p.set_data(pkg.nd.array(a, **ctx))
    return net


@pytest.mark.parametrize("dtype", sorted(HALF))
def test_gluon_trainer_multi_precision(dtype):
    """``gluon.Trainer`` with ``multi_precision`` over half weights: the
    port's gradients are set to the JAX package's after the backward, so
    the update alone is compared. float16 against the JAX Trainer; for
    bfloat16 (fault C6) the masters against the JAX Trainer run in float32
    from the rounded weights with the gradients cast to float32."""
    rs = np.random.RandomState(4)
    ws = [rs.randn(16, 8).astype(np.float32) * 0.3,
          rs.randn(16).astype(np.float32) * 0.1,
          rs.randn(4, 16).astype(np.float32) * 0.3,
          rs.randn(4).astype(np.float32) * 0.1]
    x = rs.randn(6, 8).astype(np.float32)
    y = rs.randint(0, 4, 6).astype(np.float32)
    tdt, jdt = HALF[dtype]
    net, jnet = _dense_pair(mx, ws, ctx=CPU), _dense_pair(jmx, ws)
    net.cast(dtype)
    jnet.cast(dtype if dtype == "float16" else "float32")
    if dtype == "bfloat16":
        for p in jnet.collect_params().values():
            p.set_data(jmx.nd.array(_host(p.data()._data.astype(jdt))))
    params = dict(HYPER, multi_precision=True)
    tr = mx.gluon.Trainer(net.collect_params(), "sgd", dict(params))
    jtr = jmx.gluon.Trainer(jnet.collect_params(), "sgd", dict(params))
    for _ in range(3):
        jx = jmx.nd.array(x).astype(dtype if dtype == "float16"
                                    else "float32")
        with jmx.autograd.record():
            jloss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(jnet(jx),
                                                             jmx.nd.array(y))
        jloss.backward()
        with mx.autograd.record():
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                net(mx.nd.array(x, ctx=CPU).astype(dtype)),
                mx.nd.array(y, ctx=CPU))
        loss.backward()
        for p, jp in zip(net.collect_params().values(),
                         jnet.collect_params().values()):
            g = _host(jp.grad()._data.astype(jdt))
            p.grad()._data.copy_(torch.from_numpy(g.copy()))
            if dtype == "bfloat16":   # the float32 run takes them rounded
                jp.grad()._rebind(jnp.asarray(g))
        jtr.step(6)
        tr.step(6)
    for i, (p, jp) in enumerate(zip(net.collect_params().values(),
                                    jnet.collect_params().values())):
        master = tr._states[i][0]._data
        want = _host(jtr._states[i][0]) if dtype == "float16" \
            else _host(jp.data())
        np.testing.assert_allclose(master.numpy(), want, rtol=F32_RTOL,
                                   atol=F32_ATOL)
        assert torch.equal(p.data()._data, master.to(tdt))


# ---- ShardedTrainer -------------------------------------------------------

def test_routes_on_identical_gradients_match_the_jax_rules():
    """One update of three tensors, one per route, from identical
    gradients: the float32 weight and the master through the JAX SGD rule
    (the ``opt_sgd`` dispatch) bit for bit, the master's weight its master
    rounded; the half route's bfloat16 weight and momentum within one
    ulp of the JAX rule in bfloat16."""
    rs = np.random.RandomState(7)
    w = [rs.randn(9, 5).astype(np.float32) for _ in range(3)]
    g = [rs.randn(9, 5).astype(np.float32) for _ in range(3)]
    m = [rs.randn(9, 5).astype(np.float32) * 0.1 for _ in range(3)]
    opt = mx.optimizer.SGD(**HYPER)
    jopt = jmx.optimizer.SGD(**HYPER)
    wds = [1e-4, 1e-4, 0.0]
    bf = torch.bfloat16
    t = lambda a, dt=torch.float32: torch.from_numpy(a.copy()).to(dt)  # noqa
    ws = [t(w[0]), t(w[1], bf), t(w[2], bf)]
    gs = [t(g[0]), t(g[1], bf), t(g[2], bf)]
    states = [(t(m[0]),), (ws[1].float(), t(m[1])), (t(m[2], bf),)]
    routes = opt_rules.Routes([x.dtype for x in ws], True)
    routes.half.append(2)
    routes.master.remove(2)
    routes.fused.remove(2)
    lr = torch.tensor(0.05)
    grads32 = [torch.empty(9, 5)]
    opt_rules.apply(opt_rules.RULES["sgd"], opt, routes, ws, gs, states,
                    grads32, lr, wds, torch.tensor(1.0), None)
    jlr = jnp.asarray(0.05, jnp.float32)
    rule = jrules.RULES["sgd"]
    key = jax.random.PRNGKey(0)
    w0, (m0,) = rule.update(jopt, jnp.asarray(w[0]), jnp.asarray(g[0]),
                            (jnp.asarray(m[0]),), jlr, wds[0], 1.0, key)
    b1 = jnp.asarray(w[1]).astype(jnp.bfloat16)
    w1, (m1,) = rule.update(jopt, b1.astype(jnp.float32),
                            jnp.asarray(g[1]).astype(jnp.bfloat16)
                            .astype(jnp.float32), (jnp.asarray(m[1]),),
                            jlr, wds[1], 1.0, key)
    w2, (m2,) = rule.update(jopt, jnp.asarray(w[2]).astype(jnp.bfloat16),
                            jnp.asarray(g[2]).astype(jnp.bfloat16),
                            (jnp.asarray(m[2]).astype(jnp.bfloat16),), jlr,
                            wds[2], 1.0, key)
    np.testing.assert_array_equal(ws[0].numpy(), np.asarray(w0))
    np.testing.assert_array_equal(states[0][0].numpy(), np.asarray(m0))
    np.testing.assert_array_equal(states[1][0].numpy(), np.asarray(w1))
    np.testing.assert_array_equal(states[1][1].numpy(), np.asarray(m1))
    assert torch.equal(ws[1], states[1][0].to(bf))
    for got, want in ((ws[2], w2), (states[2][0], m2)):
        ref = _host(want)
        assert got.dtype == bf
        np.testing.assert_allclose(_host(got), ref, rtol=2 ** -7,
                                   atol=2 ** -7 * float(np.abs(ref).max()))


def _batches(steps=3, batch=8):
    rs = np.random.RandomState(0)
    return (rs.rand(steps, batch, 3, 32, 32).astype(np.float32),
            rs.randint(0, 10, (steps, batch)).astype(np.float32))


def _pair(mp, nan_guard=True, seed=0):
    x, _ = _batches()
    jmx.random.seed(seed)
    # one prefix for both: each package numbers unprefixed blocks with a
    # per-process counter, which other files in the same worker advance
    jnet = jvision.get_model("resnet18_v1", classes=10, thumbnail=True,
                             prefix="thumb_")
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x[0]))
    net = vision.get_model("resnet18_v1", classes=10, thumbnail=True,
                           prefix="thumb_")
    net.initialize(ctx=CPU)
    load_jax_params(net, {n: p.data().asnumpy() for n, p in
                          jnet._collect_params_with_structure().items()})
    jnet.cast("bfloat16")
    net.cast("bfloat16")
    params = dict(HYPER, multi_precision=mp)
    jst = JaxTrainer(jnet, jmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     dict(params), mesh=JaxMesh({"dp": 1}),
                     nan_guard=nan_guard)
    st = ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                        dict(params), mesh=DeviceMesh({"dp": 1},
                                                      devices=[CPU]),
                        nan_guard=nan_guard)
    return jst, st


def _sync_from_jax(st, jst):
    for h, jh in zip(st._train_handles, jst._train_handles):
        h._data.copy_(torch.tensor(_host(jh._data)))
    for per, jper in zip(st._opt_state, jst._opt_raws):
        for s, js in zip(per, jper):
            s.copy_(torch.tensor(_host(js)))
    for h, jh in zip(st._aux_handles, jst._aux_handles):
        h._data.copy_(torch.tensor(_host(jh._data)))


def _l2(a, b, scale):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(scale), 1e-30))


@pytest.mark.parametrize("mp", [True, False])
def test_thumbnail_resnet18_in_bfloat16_matches_jax_sharded_trainer(mp,
                                                                    monkeypatch):
    jst, st = _pair(mp)
    assert st._param_names == jst._param_names
    # the state layout and dtypes: master first, as the JAX trainer's
    assert [[str(s.dtype).replace("torch.", "") for s in per]
            for per in st._opt_state] == \
        [[str(s.dtype) for s in per] for per in jst._opt_raws]
    n_half = sum(h._data.dtype == torch.bfloat16 for h in st._train_handles)
    assert (n_half, len(st._param_names)) == (22, 60)
    want_routes = {"float32": 38, "master": 22 if mp else 0,
                   "half": 0 if mp else 22}
    assert st._routes.census() == want_routes
    # K1's plain version takes every float32 tensor, the masters among
    # them, in one call a step
    calls = []
    entry = kernels.entry("opt_sgd")
    plain = entry.plain

    def counting(ws, *args, **kw):
        calls.append([w.data_ptr() for w in ws])
        return plain(ws, *args, **kw)

    monkeypatch.setattr(entry, "plain", counting)
    x, y = _batches()
    for i in range(3):
        _sync_from_jax(st, jst)
        a0 = [_host(h._data) for h in jst._aux_handles]
        want = jst.step(jmx.nd.array(x[i]).astype("bfloat16"),
                        jmx.nd.array(y[i])).asscalar()
        got = st.step(mx.nd.array(x[i], ctx=CPU).astype("bfloat16"),
                      mx.nd.array(y[i], ctx=CPU)).asscalar()
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        for h, jh, old in zip(st._aux_handles, jst._aux_handles, a0):
            ref = _host(jh._data)
            assert not np.array_equal(ref, old)
            np.testing.assert_allclose(
                _host(h._data), ref, rtol=0,
                atol=AUX_TOL * max(float(np.abs(ref).max()), 1.0))
        for k, (per, jper) in enumerate(zip(st._opt_state, jst._opt_raws)):
            step = _host(jper[-1])
            held = [(per[-1], jper[-1])]
            if len(per) == 2:   # the master, not the bfloat16 copy
                held.append((per[0], jper[0]))
                assert torch.equal(st._train_handles[k]._data,
                                   per[0].to(torch.bfloat16))
            else:
                held.append((st._train_handles[k]._data,
                             jst._train_handles[k]._data))
            for a, b in held:
                assert _l2(_host(a), _host(b), step) <= STEP_TOL, (i, k)
    assert st.route_counts == {k: 3 * v for k, v in want_routes.items()}
    masters = {st._opt_state[i][0].data_ptr() for i in st._routes.master}
    assert len(calls) == 3
    assert all(len(c) == len(st._routes.fused) and masters <= set(c)
               for c in calls)


def test_a_skipped_step_leaves_masters_weights_momenta_and_stats():
    """With ``nan_guard`` a batch holding a NaN changes nothing: the
    bfloat16 weights, the float32 masters, the momenta and the running
    statistics stay bit for bit."""
    _, st = _pair(True)
    x, y = _batches()
    st.step(mx.nd.array(x[0], ctx=CPU).astype("bfloat16"),
            mx.nd.array(y[0], ctx=CPU))
    before = [t.clone() for t in st._state_tensors().values()]
    bad = x[1].copy()
    bad[2, 0, 3, 4] = np.nan
    loss = st.step(mx.nd.array(bad, ctx=CPU).astype("bfloat16"),
                   mx.nd.array(y[1], ctx=CPU))
    assert np.isnan(loss.asscalar()) and st.skipped_steps == 1
    assert all(torch.equal(a, b) for a, b in
               zip(before, st._state_tensors().values()))


def test_master_gradient_buffers_are_aligned_and_reused():
    _, st = _pair(True)
    assert len(st._grads32) == 22
    assert all(g.dtype == torch.float32 and g.is_contiguous()
               and g.data_ptr() % 16 == 0 for g in st._grads32)
    ptrs = [g.data_ptr() for g in st._grads32]
    x, y = _batches()
    st.step(mx.nd.array(x[0], ctx=CPU).astype("bfloat16"),
            mx.nd.array(y[0], ctx=CPU))
    assert [g.data_ptr() for g in st._grads32] == ptrs
