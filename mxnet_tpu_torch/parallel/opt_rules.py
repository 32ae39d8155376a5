"""Per-optimizer update rules for the ShardedTrainer step.

Counterpart of ``mxnet_tpu/parallel/opt_rules.py``: all 17 rules of the
JAX module (sgd :85-99, nag, signum and its ``signsgd`` alias, lars,
sgld, lbsgd, dcasgd, adam :201-212, ftml, lamb :223-234, adagrad,
rmsprop, adadelta, ftrl, adamax, nadam, test; :316-332). Each rule
supplies

  init(opt, w)                                   -> tuple of state tensors
  update(opt, ws, gs, states, lr, wds, t, skip)  -> None (in place)
  plain(opt, w, g, state, lr, wd, t, skip)       -> None (in place)

``update`` runs over a list of float32 tensors: SGD with momentum and
Adam with ONE launch of the fused kernel (families ``opt_sgd`` /
``opt_adam``), LAMB with ``torch._foreach_*`` ops over the whole list
(its per-tensor norms by ``torch._foreach_norm``), the others with the
plain ops of ``ops/optimizer_op.py`` one tensor after another (they had
no TPU kernel: the JAX package jits them into its step). ``plain``
updates one float16 or bfloat16 tensor with the plain op in the
weight's own type, where the JAX package leaves such a weight to XLA
(its Pallas kernels take float32 only). ``lr`` is the float32 device scalar of the base
learning rate, ``t`` the float32 device scalar of the step count, ``wds``
the per-parameter weight decays and ``skip`` the device flag of the
non-finite guard (non-zero: leave everything as it is). Adam's bias
correction is folded into lr in float32 on the device, as the JAX rule
does under jit, so no step syncs the host. The same holds for every
rule: FTML's, LAMB's, Adamax's and Nadam's bias corrections, LBSGD's
warm-up multiplier and every norm (LARS, LAMB, LBSGD's ``lars``) are
device scalars computed from ``lr`` and ``t``, and Nadam carries its
momentum schedule as a float32 0-dim tensor in each parameter's state
(the JAX rule's third slot). SGLD draws its noise from ``mx.random``'s
generator of the weight's device, which every CUDA graph registers, so
a replayed step draws anew. Plain SGD (no momentum) had no
TPU kernel and stays plain PyTorch (``sgd_update``) on every route.

:func:`apply` runs one step over the trainer's parameters on three
routes, chosen by dtype before any launch (:class:`Routes`):

* ``float32``: float32 weights, updated by ``update`` in place;
* ``master``: half-precision weights under ``multi_precision``. Their
  float32 master copies (first in the state tuple, as the JAX trainer
  lays it out at :348-364) go through the same ``update`` call with the
  gradients cast to float32, and each weight is then rewritten as
  ``master.to(weight.dtype)`` (JAX :577-584);
* ``half``: half-precision weights without ``multi_precision``, one
  ``plain`` call each.

No route is reached by catching an error: on the card the fused kernel
launches or raises. Nothing here touches the host, so a step is captured
whole (``compile.jit``): ``_adam_lr`` works on the device
scalars, and the route census (:meth:`Routes.census`), fixed by dtype,
is added to ``ShardedTrainer.route_counts`` on the host at every call,
replayed or not.
"""
from __future__ import annotations

import torch

from .. import kernels as _kernels
from .. import random as _random
from ..base import HALF_DTYPES
from ..ops import optimizer_op as K

__all__ = ["RULES", "Rule", "Routes", "init_state", "apply"]

RULES = {}


class Rule:
    def __init__(self, init, update, plain):
        self.init = init
        self.update = update
        self.plain = plain


def _register(names, init, update, plain):
    for n in names:
        RULES[n] = Rule(init, update, plain)


def _clip(opt):
    return opt.clip_gradient if opt.clip_gradient else -1.0


def _keep(skip, old, new):
    """``new``, or ``old`` where the guard's flag says skip."""
    return new if skip is None else torch.where(skip != 0, old, new)


def _sgd_init(opt, w):
    return (torch.zeros_like(w),) if opt.momentum else ()


def _sgd_update(opt, ws, gs, states, lr, wds, t, skip):
    if opt.momentum:
        _kernels.dispatch(
            "opt_sgd", ws, gs, [st[0] for st in states], lr, wds,
            momentum=opt.momentum, rescale_grad=opt.rescale_grad,
            clip_gradient=_clip(opt), skip=skip)
        return
    for w, g, st, wd in zip(ws, gs, states, wds):
        _sgd_plain(opt, w, g, st, lr, wd, t, skip)


def _sgd_plain(opt, w, g, st, lr, wd, t, skip):
    # the learning rate in the weight's type, as the JAX rule's _lr_of
    lr = lr.to(w.dtype)
    hyper = dict(lr=lr, wd=wd, rescale_grad=opt.rescale_grad,
                 clip_gradient=_clip(opt))
    if opt.momentum:
        new_w, new_m = K.sgd_mom_update(w, g, st[0], momentum=opt.momentum,
                                        **hyper)
        st[0].copy_(_keep(skip, st[0], new_m))
    else:
        new_w = K.sgd_update(w, g, **hyper)
    w.copy_(_keep(skip, w, new_w))


def _adam_init(opt, w):
    return (torch.zeros_like(w), torch.zeros_like(w))


def _adam_lr(opt, lr, t):
    # bias correction folded into lr (reference Adam semantics)
    return lr * torch.sqrt(1.0 - opt.beta2 ** t) / (1.0 - opt.beta1 ** t)


def _adam_update(opt, ws, gs, states, lr, wds, t, skip):
    _kernels.dispatch(
        "opt_adam", ws, gs, [st[0] for st in states],
        [st[1] for st in states], _adam_lr(opt, lr, t), wds,
        beta1=opt.beta1, beta2=opt.beta2, epsilon=opt.epsilon,
        rescale_grad=opt.rescale_grad, clip_gradient=_clip(opt), skip=skip)


def _adam_plain(opt, w, g, st, lr, wd, t, skip):
    new = K.adam_update(
        w, g, st[0], st[1], lr=_adam_lr(opt, lr, t).to(w.dtype),
        beta1=opt.beta1, beta2=opt.beta2, epsilon=opt.epsilon, wd=wd,
        rescale_grad=opt.rescale_grad, clip_gradient=_clip(opt))
    for old, value in zip((w, st[0], st[1]), new):
        old.copy_(_keep(skip, old, value))


def _lr_of(lr, w):
    """The learning rate in the weight's type (the JAX rules' ``_lr_of``)."""
    return lr.to(w.dtype) if isinstance(lr, torch.Tensor) else lr


def _commit(olds, news, skip):
    """Write each new value into its tensor, in order (a state whose new
    value is the old weight is written before the weight), or keep the
    old one where the guard's flag says skip."""
    if skip is None:
        for old, new in zip(olds, news):
            old.copy_(new)
        return
    cond = (skip != 0).reshape(())
    for old, new in zip(olds, news):
        torch.where(cond, old, new.to(old.dtype), out=old)


def _per_tensor(step):
    """``(update, plain)`` from ``step(opt, w, g, st, lr, wd, t) ->
    (new weight, new states)``: the step one tensor after another, each
    tensor's new values written before the next is computed."""
    def update(opt, ws, gs, states, lr, wds, t, skip):
        for w, g, st, wd in zip(ws, gs, states, wds):
            new_w, new_st = step(opt, w, g, st, lr, wd, t)
            _commit(list(st) + [w], list(new_st) + [new_w], skip)

    def plain(opt, w, g, st, lr, wd, t, skip):
        update(opt, [w], [g], [st], lr, [wd], t, skip)

    return update, plain


def _zeros(w, n):
    return tuple(torch.zeros_like(w) for _ in range(n))


def _hyper(opt, w, lr, wd):
    return dict(lr=_lr_of(lr, w), wd=wd, rescale_grad=opt.rescale_grad,
                clip_gradient=_clip(opt))


def _prep(opt, g, w, wd, with_wd=False):
    """SGD-family prep: rescale, clip, THEN (optionally) add ``wd * w``."""
    g = K._prep_grad(g, opt.rescale_grad, _clip(opt))
    return g + wd * w if with_wd else g


def _nag_step(opt, w, g, st, lr, wd, t):
    if opt.momentum:
        w2, m2 = K.nag_mom_update(w, g, st[0], momentum=opt.momentum,
                                  **_hyper(opt, w, lr, wd))
        return w2, (m2,)
    return K.sgd_update(w, g, **_hyper(opt, w, lr, wd)), ()


def _signum_step(opt, w, g, st, lr, wd, t):
    if opt.momentum:
        w2, m2 = K.signum_update(w, g, st[0], momentum=opt.momentum,
                                 wd_lh=opt.wd_lh, **_hyper(opt, w, lr, wd))
        return w2, (m2,)
    return K.signsgd_update(w, g, **_hyper(opt, w, lr, wd)), ()


def _lars_step(opt, w, g, st, lr, wd, t):
    kw = dict(_hyper(opt, w, lr, wd), eta=opt.eta, epsilon=opt.epsilon)
    if opt.momentum:
        w2, m2 = K.lars_sgd_mom_update(w, g, st[0], momentum=opt.momentum,
                                       **kw)
        return w2, (m2,)
    return K.lars_sgd_update(w, g, **kw), ()


def _sgld_step(opt, w, g, st, lr, wd, t):
    g = _prep(opt, g, w, wd, with_wd=True)
    lr_w = _lr_of(lr, w)
    noise = torch.randn(w.shape, dtype=w.dtype, device=w.device,
                        generator=_random.generator(w.device))
    return w - lr_w / 2 * g + noise * torch.sqrt(lr_w), ()


def _lbsgd_step(opt, w, g, st, lr, wd, t):
    """The warm-up multiplier from the step count; the eager optimizer's
    accumulation over ``batch_scale`` calls is the trainer's
    ``accum_steps`` here, so the rule sees each step's gradient."""
    nwup = float(opt.warmup_epochs * opt.updates_per_epoch)
    maxmult = float(opt.batch_scale)
    if opt.warmup_strategy == "lars":
        # the trust ratio of the raw gradient; the step takes the
        # prepared one
        w2s = torch.sum(torch.square(w))
        g2s = torch.sum(torch.square(g))
        mult = torch.clamp(torch.sqrt(w2s / (g2s + wd * w2s + 1e-18)),
                           0.01, 100.0)
        g = _prep(opt, g, w, wd)
        step = (_lr_of(lr, w) * mult.to(w.dtype)) * (g + wd * w)
        if opt.momentum:
            m2 = opt.momentum * st[0] - step
            return w + m2, (m2,)
        return w - step, ()
    tt = t + float(opt.init_updates)
    if nwup <= 1:
        mult = maxmult
    else:
        if opt.warmup_strategy == "linear":
            mult = 1.0 + (maxmult - 1) * tt / nwup
        elif opt.warmup_strategy == "power2":
            mult = 1.0 + (maxmult - 1) * (tt * tt) / (nwup * nwup)
        elif opt.warmup_strategy == "sqrt":
            mult = 1.0 + (maxmult - 1) * torch.sqrt(tt / nwup)
        else:
            mult = torch.ones_like(tt)
        mult = torch.where(tt >= nwup, maxmult, mult)
    kw = _hyper(opt, w, lr * mult, wd)
    if opt.momentum:
        w2, m2 = K.sgd_mom_update(w, g, st[0], momentum=opt.momentum, **kw)
        return w2, (m2,)
    return K.sgd_update(w, g, **kw), ()


def _dcasgd_init(opt, w):
    prev = w.detach().clone()
    return (torch.zeros_like(w), prev) if opt.momentum else (prev,)


def _dcasgd_step(opt, w, g, st, lr, wd, t):
    g = _prep(opt, g, w, wd)
    prev = st[-1]
    delta = -_lr_of(lr, w) * (g + wd * w + opt.lamda * g * g * (w - prev))
    if opt.momentum:
        m2 = opt.momentum * st[0] + delta
        return w + m2, (m2, w)
    return w + delta, (w,)


def _ftml_step(opt, w, g, st, lr, wd, t):
    w2, d2, v2, z2 = K.ftml_update(
        w, g, st[0], st[1], st[2], lr=_lr_of(lr, w), beta1=opt.beta1,
        beta2=opt.beta2, epsilon=opt.epsilon, wd=wd,
        rescale_grad=opt.rescale_grad, clip_grad=_clip(opt), t=t)
    return w2, (d2, v2, z2)


def _lamb_bounds(opt):
    return dict(lower_bound=opt.lower_bound if opt.lower_bound else -1.0,
                upper_bound=opt.upper_bound if opt.upper_bound else -1.0)


def _lamb_step(opt, w, g, st, lr, wd, t):
    upd, m2, v2 = K.lamb_update_phase1(
        w, g, st[0], st[1], beta1=opt.beta1, beta2=opt.beta2,
        epsilon=opt.epsilon, t=t, bias_correction=opt.bias_correction,
        wd=wd, rescale_grad=opt.rescale_grad, clip_gradient=_clip(opt))
    w2 = K.lamb_update_phase2(w, upd, K._norm(w), K._norm(upd),
                              lr=_lr_of(lr, w), **_lamb_bounds(opt))
    return w2, (m2, v2)


def _lamb_update(opt, ws, gs, states, lr, wds, t, skip):
    """LAMB over the whole list with ``torch._foreach_*``: each op of
    ``lamb_update_phase1`` / ``lamb_update_phase2`` once over all tensors,
    in the same order (the norms by ``torch._foreach_norm``, whose sum of
    squares runs in another order than ``sqrt(sum(square))``)."""
    means = [st[0] for st in states]
    variances = [st[1] for st in states]
    g = torch._foreach_mul(gs, opt.rescale_grad)
    clip = _clip(opt)
    if clip > 0:
        torch._foreach_clamp_min_(g, -clip)
        torch._foreach_clamp_max_(g, clip)
    m2 = torch._foreach_mul(means, opt.beta1)
    torch._foreach_add_(m2, torch._foreach_mul(g, 1 - opt.beta1))
    sq = torch._foreach_mul(g, g)
    torch._foreach_mul_(sq, 1 - opt.beta2)
    v2 = torch._foreach_mul(variances, opt.beta2)
    torch._foreach_add_(v2, sq)
    if opt.bias_correction:
        m = torch._foreach_div(m2, 1 - opt.beta1 ** t)
        v = torch._foreach_div(v2, 1 - opt.beta2 ** t)
    else:
        m, v = m2, v2
    den = torch._foreach_sqrt(v)
    torch._foreach_add_(den, opt.epsilon)
    upd = torch._foreach_div(m, den)
    torch._foreach_add_(upd, torch._foreach_mul(ws, list(wds)))
    r1 = torch.stack(torch._foreach_norm(ws))
    r2 = torch.stack(torch._foreach_norm(upd))
    bounds = _lamb_bounds(opt)
    if bounds["lower_bound"] > 0:
        r1 = torch.clamp(r1, min=bounds["lower_bound"])
    if bounds["upper_bound"] > 0:
        r1 = torch.clamp(r1, max=bounds["upper_bound"])
    ratio = torch.where((r1 > 0) & (r2 > 0), r1 / r2, torch.ones_like(r1))
    step = torch._foreach_mul(upd, list((lr * ratio).unbind()))
    new_w = torch._foreach_sub(ws, step)
    _commit(means + variances + list(ws), m2 + v2 + new_w, skip)


def _lamb_plain(opt, w, g, st, lr, wd, t, skip):
    new_w, new_st = _lamb_step(opt, w, g, st, lr, wd, t)
    _commit(list(st) + [w], list(new_st) + [new_w], skip)


def _adagrad_step(opt, w, g, st, lr, wd, t):
    w2, h2 = K.adagrad_update(w, g, st[0], epsilon=opt.float_stable_eps,
                              **_hyper(opt, w, lr, wd))
    return w2, (h2,)


def _rmsprop_init(opt, w):
    return _zeros(w, 3 if opt.centered else 1)


def _rmsprop_step(opt, w, g, st, lr, wd, t):
    kw = dict(_hyper(opt, w, lr, wd), gamma1=opt.gamma1,
              epsilon=opt.epsilon,
              clip_weights=opt.clip_weights if opt.clip_weights else -1.0)
    if opt.centered:
        w2, n2, g2, d2 = K.rmspropalex_update(w, g, st[0], st[1], st[2],
                                              gamma2=opt.gamma2, **kw)
        return w2, (n2, g2, d2)
    w2, n2 = K.rmsprop_update(w, g, st[0], **kw)
    return w2, (n2,)


def _adadelta_step(opt, w, g, st, lr, wd, t):
    w2, a2, d2 = K.adadelta_update(
        w, g, st[0], st[1], rho=opt.rho, epsilon=opt.epsilon, wd=wd,
        rescale_grad=opt.rescale_grad, clip_gradient=_clip(opt))
    return w2, (a2, d2)


def _ftrl_step(opt, w, g, st, lr, wd, t):
    w2, z2, n2 = K.ftrl_update(w, g, st[0], st[1], lamda1=opt.lamda1,
                               beta=opt.beta, **_hyper(opt, w, lr, wd))
    return w2, (z2, n2)


def _adamax_step(opt, w, g, st, lr, wd, t):
    g = K._prep_grad_wd(g, w, opt.rescale_grad, _clip(opt), wd)
    m2 = opt.beta1 * st[0] + (1.0 - opt.beta1) * g
    u2 = torch.maximum(opt.beta2 * st[1], torch.abs(g))
    lr_eff = _lr_of(lr / (1.0 - opt.beta1 ** t), w)
    return w - lr_eff * m2 / (u2 + 1e-8), (m2, u2)


def _nadam_init(opt, w):
    # the third slot: the cumulative momentum schedule of this parameter
    # (the JAX rule's layout; the eager optimizer shares one float)
    return _zeros(w, 2) + (torch.ones((), dtype=torch.float32,
                                      device=w.device),)


def _nadam_step(opt, w, g, st, lr, wd, t):
    g = K._prep_grad_wd(g, w, opt.rescale_grad, _clip(opt), wd)
    psi = opt.schedule_decay
    mom_t = opt.beta1 * (1.0 - 0.5 * 0.96 ** (t * psi))
    mom_t1 = opt.beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1.0) * psi))
    sched = st[2] * mom_t
    sched_next = sched * mom_t1
    m2 = opt.beta1 * st[0] + (1.0 - opt.beta1) * g
    v2 = opt.beta2 * st[1] + (1.0 - opt.beta2) * g * g
    g_prime = g / (1.0 - sched).to(w.dtype)
    m_prime = m2 / (1.0 - sched_next).to(w.dtype)
    v_prime = v2 / (1.0 - opt.beta2 ** t).to(w.dtype)
    m_bar = ((1.0 - mom_t).to(w.dtype) * g_prime
             + mom_t1.to(w.dtype) * m_prime)
    w2 = w - _lr_of(lr, w) * m_bar / (torch.sqrt(v_prime) + opt.epsilon)
    return w2, (m2, v2, sched)


def _test_step(opt, w, g, st, lr, wd, t):
    w2 = w - g * opt.rescale_grad * _lr_of(lr, w)
    return w2, (w2,)


_register(["sgd"], _sgd_init, _sgd_update, _sgd_plain)
_register(["adam"], _adam_init, _adam_update, _adam_plain)
_register(["lamb"], lambda opt, w: _zeros(w, 2), _lamb_update, _lamb_plain)
for _names, _init, _step in (
        (["nag"], _sgd_init, _nag_step),
        (["signum", "signsgd"], _sgd_init, _signum_step),
        (["lars"], _sgd_init, _lars_step),
        (["sgld"], lambda opt, w: (), _sgld_step),
        (["lbsgd"], _sgd_init, _lbsgd_step),
        (["dcasgd"], _dcasgd_init, _dcasgd_step),
        (["ftml"], lambda opt, w: _zeros(w, 3), _ftml_step),
        (["adagrad"], lambda opt, w: _zeros(w, 1), _adagrad_step),
        (["rmsprop"], _rmsprop_init, _rmsprop_step),
        (["adadelta"], lambda opt, w: _zeros(w, 2), _adadelta_step),
        (["ftrl"], lambda opt, w: _zeros(w, 2), _ftrl_step),
        (["adamax"], lambda opt, w: _zeros(w, 2), _adamax_step),
        (["nadam"], _nadam_init, _nadam_step),
        (["test"], lambda opt, w: _zeros(w, 1), _test_step)):
    _register(_names, _init, *_per_tensor(_step))

class Routes:
    """Which parameter takes which route, from the weights' dtypes and
    ``multi_precision``; fixed for a trainer, as its dtypes are.

    ``fused``: positions of the tensors of the one fused launch, in
    parameter order (float32 weights and the masters); ``master``: the
    positions among them whose weight is half precision (a subset);
    ``half``: positions updated by the plain op in their own type."""

    def __init__(self, dtypes, multi_precision):
        self.fused, self.master, self.half = [], [], []
        for i, dt in enumerate(dtypes):
            if dt not in HALF_DTYPES:
                self.fused.append(i)
            elif multi_precision:
                self.fused.append(i)
                self.master.append(i)
            else:
                self.half.append(i)

    def census(self):
        """Tensors per route in one step."""
        return {"float32": len(self.fused) - len(self.master),
                "master": len(self.master), "half": len(self.half)}


def init_state(rule, opt, w, multi_precision):
    """The state tuple of weight ``w``: under ``multi_precision`` a half
    weight's float32 master copy comes first and the rule's own state is
    made in float32 (the JAX trainer's ``_init_opt_state``)."""
    if multi_precision and w.dtype in HALF_DTYPES:
        w32 = w.detach().to(torch.float32)
        return (w32,) + rule.init(opt, w32)
    return rule.init(opt, w)


def apply(rule, opt, routes, ws, gs, states, grads32, lr, wds, t, skip):
    """One update of every parameter, in place, on its route. ``grads32``
    holds one float32 buffer per master (contiguous, 16-byte aligned)
    into which the half gradients are cast before the fused launch."""
    cast = dict(zip(routes.master, grads32))   # master position -> buffer
    if routes.master:
        torch._foreach_copy_(grads32, [gs[i] for i in routes.master])
    if routes.fused:
        rule.update(
            opt,
            [states[i][0] if i in cast else ws[i] for i in routes.fused],
            [cast.get(i, gs[i]) for i in routes.fused],
            [states[i][1:] if i in cast else states[i]
             for i in routes.fused],
            lr, [wds[i] for i in routes.fused], t, skip)
    for i in routes.half:
        rule.plain(opt, ws[i], gs[i], states[i], lr, wds[i], t, skip)
    if routes.master:
        halves = [ws[i] for i in routes.master]
        masters = [states[i][0] for i in routes.master]
        if skip is None:
            torch._foreach_copy_(halves, masters)
        else:
            for w, m in zip(halves, masters):
                w.copy_(_keep(skip, w, m.to(w.dtype)))
