"""Per-optimizer update rules for the ShardedTrainer step.

Counterpart of ``mxnet_tpu/parallel/opt_rules.py`` (sgd :85-99, adam
:201-212). Each rule supplies

  init(opt, w)                                   -> tuple of state tensors
  update(opt, ws, gs, states, lr, wds, t, skip)  -> None (in place)
  plain(opt, w, g, state, lr, wd, t, skip)       -> None (in place)

``update`` runs over a list of float32 tensors with ONE launch of the
fused kernel (families ``opt_sgd`` / ``opt_adam``); ``plain`` updates one
float16 or bfloat16 tensor with the plain op in the weight's own type,
where the JAX package leaves such a weight to XLA (its Pallas kernels
take float32 only). ``lr`` is the float32 device scalar of the base
learning rate, ``t`` the float32 device scalar of the step count, ``wds``
the per-parameter weight decays and ``skip`` the device flag of the
non-finite guard (non-zero: leave everything as it is). Adam's bias
correction is folded into lr in float32 on the device, as the JAX rule
does under jit, so no step syncs the host. Plain SGD (no momentum) had no
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


_register(["sgd"], _sgd_init, _sgd_update, _sgd_plain)
_register(["adam"], _adam_init, _adam_update, _adam_plain)


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
