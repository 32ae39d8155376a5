"""Per-optimizer update rules for the ShardedTrainer step.

Counterpart of ``mxnet_tpu/parallel/opt_rules.py`` (sgd :85-99, adam
:201-212). Each rule supplies

  init(opt, w)                                  -> tuple of state tensors
  update(opt, ws, gs, states, lr, wds, t, skip) -> None (in place)

over the step's whole parameter list: ``lr`` is the float32 device
scalar of the base learning rate, ``t`` the float32 device scalar of the
step count, ``wds`` the per-parameter weight decays and ``skip`` the
device flag of the non-finite guard (non-zero: leave everything as it
is). SGD with momentum and Adam go through ONE launch of the fused
kernels (families ``opt_sgd`` / ``opt_adam``); Adam's bias correction is
folded into lr in float32 on the device, as the JAX rule does under jit,
so no step syncs the host. Plain SGD (no momentum) had no TPU kernel and
stays plain PyTorch (``sgd_update``), selected on the device by ``skip``.
"""
from __future__ import annotations

import torch

from .. import kernels as _kernels
from ..ops import optimizer_op as K

__all__ = ["RULES", "Rule"]

RULES = {}


class Rule:
    def __init__(self, init, update):
        self.init = init
        self.update = update


def _register(names, init, update):
    for n in names:
        RULES[n] = Rule(init, update)


def _clip(opt):
    return opt.clip_gradient if opt.clip_gradient else -1.0


def _sgd_init(opt, w):
    return (torch.zeros_like(w),) if opt.momentum else ()


def _sgd_update(opt, ws, gs, states, lr, wds, t, skip):
    if opt.momentum:
        _kernels.dispatch(
            "opt_sgd", ws, gs, [st[0] for st in states], lr, wds,
            momentum=opt.momentum, rescale_grad=opt.rescale_grad,
            clip_gradient=_clip(opt), skip=skip)
        return
    with torch.no_grad():
        for w, g, wd in zip(ws, gs, wds):
            new = K.sgd_update(w, g, lr=lr, wd=wd,
                               rescale_grad=opt.rescale_grad,
                               clip_gradient=_clip(opt))
            w.copy_(new if skip is None else torch.where(skip != 0, w, new))


def _adam_init(opt, w):
    return (torch.zeros_like(w), torch.zeros_like(w))


def _adam_update(opt, ws, gs, states, lr, wds, t, skip):
    # bias correction folded into lr (reference Adam semantics)
    lr_eff = lr * torch.sqrt(1.0 - opt.beta2 ** t) / (1.0 - opt.beta1 ** t)
    _kernels.dispatch(
        "opt_adam", ws, gs, [st[0] for st in states],
        [st[1] for st in states], lr_eff, wds, beta1=opt.beta1,
        beta2=opt.beta2, epsilon=opt.epsilon, rescale_grad=opt.rescale_grad,
        clip_gradient=_clip(opt), skip=skip)


_register(["sgd"], _sgd_init, _sgd_update)
_register(["adam"], _adam_init, _adam_update)
