"""The optimizer surface of the port on the CPU against the JAX package:
every update op of ``ops/optimizer_op.py`` against the JAX op, all 17
optimizers through ``update``, ``update_multi_precision`` and
``Updater.update_multi`` against the JAX optimizers, and SGLD's noise.

Tolerances. Float32 on the CPU: the two frameworks evaluate the same
expressions op for op, but XLA may contract or reorder a few of them
(and ``sqrt``/``pow`` differ in the last ulp), so values are held to
``rtol = 1e-5, atol = 1e-6`` per step (largest error met: 7.2e-7, FTML
after 3 steps). Half precision: the masters are float32 and held as
float32; each float16 weight is its master rounded.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as preg
from mxnet_tpu_torch.optimizer import optimizer as popt

CPU = mx.cpu()
RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(4, 5), (7,), (3, 2, 2)]


def _rand(shape, seed, scale=1.0, positive=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return np.abs(x) + 0.1 if positive else x


# ------------------------------------------------------------- the ops ----
# op -> (input kinds, hyper-parameters); kinds: "w" weight, "g" gradient,
# "s" a signed state, "p" a positive state (accumulators of squares),
# "h" a float16 weight
_MOM = dict(lr=0.05, momentum=0.9, wd=0.01, rescale_grad=0.5,
            clip_gradient=0.3)
SINGLE = {
    "sgd_update": ("wg", dict(lr=0.05, wd=0.01, rescale_grad=0.5,
                              clip_gradient=0.3)),
    "sgd_mom_update": ("wgs", _MOM),
    "mp_sgd_update": ("hgw", dict(lr=0.05, wd=0.01, clip_gradient=0.3)),
    "mp_sgd_mom_update": ("hgsw", _MOM),
    "nag_mom_update": ("wgs", _MOM),
    "mp_nag_mom_update": ("hgsw", _MOM),
    "signsgd_update": ("wg", dict(lr=0.05, wd=0.01)),
    "signum_update": ("wgs", dict(lr=0.05, momentum=0.9, wd=0.01,
                                  wd_lh=0.02, clip_gradient=0.3)),
    "adam_update": ("wgsp", dict(lr=0.01, wd=0.01, clip_gradient=0.3)),
    "ftml_update": ("wgppp", dict(lr=0.01, wd=0.01, t=3, clip_grad=0.3)),
    "rmsprop_update": ("wgp", dict(lr=0.01, wd=0.01, clip_gradient=0.3,
                                   clip_weights=0.9)),
    "rmspropalex_update": ("wgpss", dict(lr=0.01, wd=0.01,
                                         clip_weights=0.9)),
    "ftrl_update": ("wgsp", dict(lr=0.1, lamda1=0.5, wd=0.01,
                                 clip_gradient=0.3)),
    "adagrad_update": ("wgp", dict(lr=0.05, wd=0.01, clip_gradient=0.3)),
    "_sparse_adagrad_update": ("wgp", dict(lr=0.05, wd=0.01)),
    "adadelta_update": ("wgpp", dict(rho=0.9, wd=0.01, clip_gradient=0.3)),
    "lars_sgd_update": ("wg", dict(lr=0.05, eta=0.01, wd=0.01)),
    "lars_sgd_mom_update": ("wgs", dict(lr=0.05, eta=0.01, momentum=0.9,
                                        wd=0.01, clip_gradient=0.3)),
    "lamb_update_phase1": ("wgsp", dict(t=2, wd=0.01, clip_gradient=0.3)),
    "mp_lamb_update_phase1": ("hgspw", dict(t=2, wd=0.01)),
    "_contrib_group_adagrad_update": ("wgp", dict(lr=0.05,
                                                  clip_gradient=0.3)),
    "group_adagrad_update": ("wgp", dict(lr=0.05)),
}


def _inputs(kinds, shape, seed):
    out = []
    for i, k in enumerate(kinds):
        if k == "h":
            out.append(_rand(shape, seed + i).astype(np.float16))
        else:
            out.append(_rand(shape, seed + i, positive=(k == "p")))
    return out


def _both(name, arrays, kw):
    got = preg.get(name)(*(torch.from_numpy(np.asarray(a)) for a in arrays),
                         **kw)
    want = jreg.get(name).fn(*(jnp.asarray(a) for a in arrays), **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _close(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        tol = dict(rtol=1e-3, atol=1e-3) if g.dtype == np.float16 else \
            dict(rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g.astype(np.float32),
                                   w.astype(np.float32), err_msg=f"{what}[{i}]",
                                   **tol)


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_tensor_update_op_matches_jax(name):
    kinds, kw = SINGLE[name]
    for shape in ((6, 5), (3, 1, 4)):
        arrays = _inputs(kinds, shape, seed=len(name))
        _close(*_both(name, arrays, kw), f"{name}{shape}")


def test_lamb_phase2_and_its_bounds_match_jax():
    w, u = _rand((5, 4), 1), _rand((5, 4), 2)
    for r1, r2, kw in ((3.0, 2.0, {}), (3.0, 2.0, dict(lower_bound=4.0)),
                       (3.0, 2.0, dict(upper_bound=1.0)), (0.0, 2.0, {}),
                       (3.0, 0.0, {})):
        r = [np.float32(r1), np.float32(r2)]
        got, want = _both("lamb_update_phase2", [w, u] + r,
                          dict(lr=0.1, **kw))
        _close(got, want, f"phase2 {r1} {r2} {kw}")
        h = w.astype(np.float16)
        got, want = _both("mp_lamb_update_phase2", [h, u] + r + [w],
                          dict(lr=0.1, **kw))
        _close(got, want, f"mp phase2 {r1} {r2} {kw}")


@pytest.mark.parametrize("name", ["_adamw_update", "adamw_update",
                                  "_mp_adamw_update", "mp_adamw_update"])
@pytest.mark.parametrize("rescale", [0.5, float("inf")])
def test_adamw_updates_and_their_skip_match_jax(name, rescale):
    mp = "mp" in name
    w, g = _rand((6, 3), 1), _rand((6, 3), 2)
    m, v = _rand((6, 3), 3), _rand((6, 3), 4, positive=True)
    arrays = ([w.astype(np.float16), g, m, v, w] if mp else [w, g, m, v]) \
        + [np.float32(rescale)]
    kw = dict(lr=0.01, wd=0.01, eta=0.5, clip_gradient=0.3)
    got, want = _both(name, arrays, kw)
    _close(got, want, name)
    if math.isinf(rescale):   # not finite: the step is skipped
        np.testing.assert_array_equal(got[-1] if mp else got[0], w)


def _multi_args(per, n, shape, seed):
    out = []
    for i in range(n):
        out += _inputs(per, shape, seed + 10 * i)
    return out


MULTI = {
    "multi_sgd_update": ("wg", dict(lrs=(0.1, 0.05), wds=(0.01, 0.0),
                                    rescale_grad=0.5, clip_gradient=0.3)),
    "multi_sgd_mom_update": ("wgs", dict(lrs=(0.1, 0.05), wds=(0.01, 0.0),
                                         momentum=0.9)),
    "multi_mp_sgd_update": ("hgw", dict(lrs=(0.1, 0.05), wds=(0.01, 0.0))),
    "multi_mp_sgd_mom_update": ("hgsw", dict(lrs=(0.1, 0.05),
                                             wds=(0.01, 0.0), momentum=0.9,
                                             clip_gradient=0.3)),
    "_multi_lamb_update": ("wgsp", dict(learning_rates=(0.1, 0.05),
                                        wds=(0.01, 0.0), step_count=(2, 3),
                                        num_tensors=2)),
    "multi_lamb_update": ("wgsp", dict(learning_rates=(0.1, 0.05),
                                       wds=(0.01, 0.0), num_tensors=2,
                                       lower_bound=0.5, upper_bound=3.0)),
    "_multi_mp_lamb_update": ("hgspw", dict(learning_rates=(0.1, 0.05),
                                            wds=(0.01, 0.0),
                                            step_count=(2, 3),
                                            num_tensors=2)),
    "multi_mp_lamb_update": ("hgspw", dict(learning_rates=(0.1, 0.05),
                                           wds=(0.01, 0.0), num_tensors=2)),
}


@pytest.mark.parametrize("name", sorted(MULTI))
def test_multi_tensor_update_op_matches_jax(name):
    per, kw = MULTI[name]
    kw = dict(kw)
    kw.setdefault("num_weights", 2) if "lamb" not in name else None
    args = _multi_args(per, 2, (5, 3), seed=3)
    got, want = _both(name, args, kw)
    _close(got, want, name)
    assert len(got) == preg.num_outputs(name, len(args), kw)


@pytest.mark.parametrize("name", ["preloaded_multi_sgd_update",
                                  "preloaded_multi_sgd_mom_update",
                                  "preloaded_multi_mp_sgd_update",
                                  "preloaded_multi_mp_sgd_mom_update"])
def test_preloaded_multi_update_op_matches_jax(name):
    per = {"preloaded_multi_sgd_update": "wg",
           "preloaded_multi_sgd_mom_update": "wgs",
           "preloaded_multi_mp_sgd_update": "hgw",
           "preloaded_multi_mp_sgd_mom_update": "hgsw"}[name]
    args = _multi_args(per, 2, (4, 4), seed=5) + [
        np.array([0.1, 0.05], np.float32), np.array([0.01, 0.0], np.float32)]
    kw = dict(num_weights=2, rescale_grad=0.5, clip_gradient=0.3)
    if "mom" in name:
        kw["momentum"] = 0.9
    _close(*_both(name, args, kw), name)


@pytest.mark.parametrize("name", ["_multi_adamw_update",
                                  "multi_adamw_update",
                                  "_multi_mp_adamw_update",
                                  "multi_mp_adamw_update"])
def test_multi_adamw_update_op_matches_jax(name):
    per = "hgspw" if "mp" in name else "wgsp"
    args = _multi_args(per, 2, (4, 3), seed=7) + [np.float32(0.5)]
    kw = dict(lrs=(0.01, 0.02), wds=(0.01, 0.0), etas=(1.0, 0.5),
              num_weights=2, clip_gradient=0.3)
    _close(*_both(name, args, kw), name)


def test_multi_lars_group_adagrad_and_utility_ops_match_jax():
    rs = np.random.RandomState(0)
    lrs = np.array([0.1, 0.2, 0.3], np.float32)
    wsq = np.array([4.0, 0.0, 9.0], np.float32)
    gsq = np.array([1.0, 2.0, 0.0], np.float32)
    wds = np.array([0.01, 0.0, 0.1], np.float32)
    _close(*_both("multi_lars", [lrs, wsq, gsq, wds],
                  dict(eta=0.01, eps=1e-8, rescale_grad=0.5)), "multi_lars")
    x = rs.randn(3, 4).astype(np.float32)
    _close(*_both("all_finite", [x], {}), "all_finite")
    x[1, 2] = np.nan
    _close(*_both("all_finite", [x], {}), "all_finite nan")
    a, b = x.astype(np.float16), rs.randn(2).astype(np.float32)
    for narrow in (False, True):
        _close(*_both("amp_multicast", [a, b],
                      dict(num_outputs=2, cast_narrow=narrow)),
               f"amp_multicast {narrow}")
    got, want = _both("reset_arrays", [a, b], dict(num_arrays=2))
    _close(got, want, "reset_arrays")
    assert preg.differentiable("all_finite") is False
    assert preg.differentiable("reset_arrays") is False


def test_every_name_of_the_jax_optimizer_op_module_is_registered():
    from pathlib import Path

    src = Path(jmx.__file__).parent / "ops" / "optimizer_op.py"
    names = []

    def register(name, aliases=(), **kw):
        names.extend((name,) + tuple(aliases))
        return lambda fn: type("Op", (), {"fn": staticmethod(fn),
                                           "name": name})

    code = src.read_text().replace("from .registry import register", "")
    exec(compile(code, str(src), "exec"), {"register": register,
                                           "__name__": "probe"})
    assert len(set(names)) >= 40
    missing = sorted(set(names) - set(preg._REGISTRY))
    assert not missing, missing
    for name in set(names):
        j = jreg.get(name)
        if not callable(getattr(j, "num_outputs", None)):
            assert preg.num_outputs(name) == (j.num_outputs or 1), name


# ------------------------------------------------------ the optimizers ----
HYPER = dict(learning_rate=0.05, wd=0.01, clip_gradient=0.5,
             rescale_grad=0.5)
MOMENTUM = {"sgd", "nag", "signum", "lars", "lbsgd", "dcasgd"}
EXTRA = {"lbsgd": dict(batch_scale=2, warmup_epochs=1, updates_per_epoch=2),
         "rmsprop": dict(centered=True, clip_weights=2.0),
         "lamb": dict(lower_bound=0.1, upper_bound=5.0)}
DETERMINISTIC = sorted(set(popt._ZOO) - {"sgld"})


def _opt_kwargs(name, scheduler=False):
    kw = dict(HYPER, **EXTRA.get(name, {}))
    if name in MOMENTUM:
        kw["momentum"] = 0.9
    return kw


def _pair(name, **extra):
    p = popt.create(name, **_opt_kwargs(name), **extra)
    j = jmx.optimizer.create(name, **_opt_kwargs(name), **extra)
    return p, j


def _arrays(dtype=np.float32, seed=0):
    return [_rand(s, seed + i).astype(dtype) for i, s in enumerate(SHAPES)]


def _held(pw, jw, what, rtol=RTOL, atol=ATOL):
    for i, (a, b) in enumerate(zip(pw, jw)):
        np.testing.assert_allclose(
            a.asnumpy().astype(np.float32), b.asnumpy().astype(np.float32),
            rtol=rtol, atol=atol, err_msg=f"{what} tensor {i}")


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_optimizer_update_matches_jax(name):
    """Three steps of ``update`` per parameter, with clip, rescale,
    weight decay and an ``lr_mult`` / ``wd_mult`` on one parameter."""
    p, j = _pair(name)
    for o in (p, j):
        o.set_lr_mult({1: 0.5})
        o.set_wd_mult({2: 0.0})
    pw = [mx.nd.array(w, ctx=CPU) for w in _arrays()]
    jw = [jmx.nd.array(w) for w in _arrays()]
    ps = [p.create_state(i, w) for i, w in enumerate(pw)]
    js = [j.create_state(i, w) for i, w in enumerate(jw)]
    for step in range(3):
        for i, g in enumerate(_arrays(seed=10 * (step + 1))):
            p.update(i, pw[i], mx.nd.array(g, ctx=CPU), ps[i])
            j.update(i, jw[i], jmx.nd.array(g), js[i])
        _held(pw, jw, f"{name} step {step}")
    assert p.num_update == j.num_update


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_updater_update_multi_with_a_scheduler_matches_jax(name):
    """``Updater.update_multi`` over all parameters at once under a
    FactorScheduler (the rate halves every step)."""
    p, j = (popt.create(name, lr_scheduler=mx.lr_scheduler.FactorScheduler(
        1, 0.5), **_opt_kwargs(name)),
        jmx.optimizer.create(name, lr_scheduler=jmx.lr_scheduler.
                             FactorScheduler(1, 0.5), **_opt_kwargs(name)))
    pu, ju = popt.get_updater(p), jmx.optimizer.get_updater(j)
    pw = [mx.nd.array(w, ctx=CPU) for w in _arrays()]
    jw = [jmx.nd.array(w) for w in _arrays()]
    for step in range(3):
        gs = _arrays(seed=10 * (step + 1))
        pu.update_multi([0, 1, 2], [mx.nd.array(g, ctx=CPU) for g in gs], pw)
        ju.update_multi([0, 1, 2], [jmx.nd.array(g) for g in gs], jw)
        _held(pw, jw, f"{name} step {step}")
    assert p.learning_rate == j.learning_rate


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_update_multi_precision_keeps_float32_masters_as_jax(name):
    """float16 weights under ``multi_precision``: the float32 masters
    against the JAX package's (which makes them for float16), each weight
    its master rounded."""
    p, j = _pair(name, multi_precision=True)
    half = _arrays(np.float16)
    pw = [mx.nd.array(w, ctx=CPU, dtype="float16") for w in half]
    jw = [jmx.nd.array(w, dtype="float16") for w in half]
    ps = [p.create_state_multi_precision(i, w) for i, w in enumerate(pw)]
    js = [j.create_state_multi_precision(i, w) for i, w in enumerate(jw)]
    for step in range(3):
        for i, g in enumerate(_arrays(np.float16, seed=10 * (step + 1))):
            p.update_multi_precision(i, pw[i], mx.nd.array(
                g, ctx=CPU, dtype="float16"), ps[i])
            j.update_multi_precision(i, jw[i], jmx.nd.array(
                g, dtype="float16"), js[i])
    _held([s[0] for s in ps], [s[0] for s in js], f"{name} masters")
    for w, s in zip(pw, ps):
        assert w.dtype == torch.float16
        np.testing.assert_array_equal(
            w.asnumpy(), s[0].asnumpy().astype(np.float16))


@pytest.mark.parametrize("name", sorted(set(DETERMINISTIC) - {"test"}))
def test_bfloat16_weights_get_masters_unlike_the_jax_eager_optimizer(name):
    """Fault C6 for every optimizer: the JAX eager optimizer makes no
    master for a bfloat16 weight (``str()`` of its dtype is a class
    name); the port makes one, and its update equals the JAX update of
    the float32 copies. (``Test``'s state is float32 in both packages
    whatever the weight, so it shows no difference.)"""
    p, j = _pair(name, multi_precision=True)
    w16 = mx.nd.array(_arrays()[0], ctx=CPU).astype("bfloat16")
    jw16 = jmx.nd.array(_arrays()[0]).astype("bfloat16")
    jstate = j.create_state_multi_precision(0, jw16)
    leaf = jstate[0] if isinstance(jstate, tuple) else jstate
    assert str(leaf.dtype) != "float32"   # no float32 master in JAX
    state = p.create_state_multi_precision(0, w16)
    assert state[0].dtype == torch.float32
    jw32 = jmx.nd.array(state[0].asnumpy())
    js = j.create_state(0, jw32)
    g = _arrays(seed=3)[0]
    p.update_multi_precision(0, w16, mx.nd.array(g, ctx=CPU).astype(
        "bfloat16"), state)
    jg = jmx.nd.array(mx.nd.array(g, ctx=CPU).astype("bfloat16").astype(
        "float32").asnumpy())
    j.update(0, jw32, jg, js)
    _held([state[0]], [jw32], f"{name} bfloat16 master")


def test_nag_multi_tensor_step_uses_foreach_and_matches_the_loop():
    """NAG's ``fused_update_multi`` over float32 weights equals its own
    single-tensor op (``nag_mom_update``) applied one tensor at a time,
    bit for bit: the ``_foreach`` form rounds op for op as it does."""
    opt = popt.create("nag", momentum=0.9, **HYPER)
    ws = [mx.nd.array(w, ctx=CPU) for w in _arrays()]
    states = [opt.create_state(i, w) for i, w in enumerate(ws)]
    want_w = [w.asnumpy().copy() for w in ws]
    want_m = [np.zeros_like(w) for w in want_w]
    for step in range(3):
        gs = _arrays(seed=step + 20)
        opt.fused_update_multi([0, 1, 2], ws,
                               [mx.nd.array(g, ctx=CPU) for g in gs], states)
        lr = opt.learning_rate
        for i, g in enumerate(gs):
            w2, m2 = preg.get("nag_mom_update")(
                torch.from_numpy(want_w[i]), torch.from_numpy(g),
                torch.from_numpy(want_m[i]), lr=lr, momentum=0.9,
                wd=HYPER["wd"], rescale_grad=HYPER["rescale_grad"],
                clip_gradient=HYPER["clip_gradient"])
            want_w[i], want_m[i] = w2.numpy(), m2.numpy()
        for w, s, ww, wm in zip(ws, states, want_w, want_m):
            np.testing.assert_array_equal(w.asnumpy(), ww)
            np.testing.assert_array_equal(s.asnumpy(), wm)


def test_sgld_deterministic_part_and_noise_match_n0_lr():
    """SGLD: the weight minus the noise the port drew (redrawn from the
    same generator state) is the JAX update without noise; over a large
    tensor the noise has mean 0 and variance lr."""
    from mxnet_tpu_torch import random as prandom

    lr, wd = 0.04, 0.01
    opt = popt.create("sgld", learning_rate=lr, wd=wd, rescale_grad=0.5,
                      clip_gradient=0.5)
    w0 = _rand((200, 100), 1)
    g = _rand((200, 100), 2)
    w = mx.nd.array(w0, ctx=CPU)
    mx.random.seed(7)
    state = prandom.get_state(torch.device("cpu")).clone()
    opt.update(0, w, mx.nd.array(g, ctx=CPU), None)
    prandom.set_state(7, state, torch.device("cpu"))
    noise = mx.nd.random.normal(0, math.sqrt(lr), shape=w0.shape,
                                ctx=CPU).asnumpy()
    gj = np.clip(g * 0.5, -0.5, 0.5)
    want = w0 - lr / 2 * (gj + wd * w0)
    np.testing.assert_allclose(w.asnumpy() - noise, want, rtol=1e-5,
                               atol=1e-6)
    drawn = w.asnumpy() - want
    assert abs(drawn.mean()) < 4 * math.sqrt(lr / drawn.size)
    assert abs(drawn.var() / lr - 1) < 0.05


def test_every_optimizer_of_the_zoo_is_created_and_registered():
    assert sorted(popt.Optimizer.opt_registry) == \
        sorted(jmx.optimizer.Optimizer.opt_registry) == sorted(popt._ZOO)
    for name in popt._ZOO:
        assert type(popt.create(name)).__name__ == \
            type(jmx.optimizer.create(name)).__name__
    assert popt.SignSGD is popt.Signum
