"""Optimizer update steps as ops: the plain versions of the fused kernels
and every other update of the JAX package.

Counterpart of ``mxnet_tpu/ops/optimizer_op.py:25-621``: the gradient
prep of :25-43, the single-tensor updates (SGD, NAG, signSGD/Signum,
Adam, FTML, RMSProp, RMSPropAlex, FTRL, AdaGrad, AdaDelta, LARS, LAMB's
two phases, AdamW) with their multi-precision forms, the multi-tensor
and preloaded families, ``multi_lars``, group AdaGrad, ``all_finite``,
``amp_multicast`` and ``reset_arrays``. Each is a function of tensors
returning new tensors, written op for op in the JAX ops' order, so that
PyTorch (which rounds after every op and never contracts ``a*b+c``)
gives the IEEE results that the CUDA kernels of ``kernels/opt_step.py``
reproduce bit for bit. ``lr`` may be a Python float or a float32 0-dim
tensor (the device scalar the kernels read). The SGD family clips the
rescaled gradient before adding weight decay (``_prep_grad``); the Adam
family folds ``wd * weight`` in before the clip (``_prep_grad_wd``).
None of these had a TPU kernel apart from the two of K1/K2: the JAX
package jits them into XLA, so here they are plain PyTorch.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["sgd_update", "sgd_mom_update", "adam_update"]


def _prep_grad(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _prep_grad_wd(grad, weight, rescale_grad, clip_gradient, wd):
    """Adam-family prep: ``wd*weight`` folds in BEFORE the clip (the SGD
    family clips first)."""
    g = grad * rescale_grad + wd * weight
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _f32(t):
    return t.to(torch.float32)


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w


def _norm(t):
    """``sqrt(sum(t^2))``, the JAX ops' per-tensor norm."""
    return torch.sqrt(torch.sum(torch.square(t)))


@register("sgd_update")
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


@register("sgd_mom_update", num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    mom_new = momentum * mom - lr * (g + wd * weight)
    return weight + mom_new, mom_new


@register("mp_sgd_update", num_outputs=2)
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """Multi-precision: ``weight`` is half precision, ``weight32`` its
    float32 master."""
    g = _prep_grad(_f32(grad), rescale_grad, clip_gradient)
    w32 = weight32 - lr * (g + wd * weight32)
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", num_outputs=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    g = _prep_grad(_f32(grad), rescale_grad, clip_gradient)
    mom_new = momentum * mom - lr * (g + wd * weight32)
    w32 = weight32 + mom_new
    return w32.to(weight.dtype), mom_new, w32


@register("nag_mom_update", num_outputs=2)
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient) + wd * weight
    mom_new = momentum * mom + g
    return weight - lr * (g + momentum * mom_new), mom_new


@register("signsgd_update")
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", num_outputs=2)
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    mom_new = momentum * mom - (1.0 - momentum) * (g + wd * weight)
    w = (1 - lr * wd_lh) * weight + lr * torch.sign(mom_new)
    return w, mom_new


@register("adam_update", num_outputs=3)
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _prep_grad_wd(grad, weight, rescale_grad, clip_gradient, wd)
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - lr * mean_new / (torch.sqrt(var_new) + epsilon)
    return w, mean_new, var_new


@register("ftml_update", num_outputs=4)
def ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_grad=-1.0, t=1):
    g = _prep_grad_wd(grad, weight, rescale_grad, clip_grad, wd)
    v_new = beta2 * v + (1 - beta2) * torch.square(g)
    d_new = (1 - beta1 ** t) / lr * (torch.sqrt(v_new / (1 - beta2 ** t))
                                     + epsilon)
    sigma = d_new - beta1 * d
    z_new = beta1 * z + (1 - beta1) * g - sigma * weight
    return -z_new / d_new, d_new, v_new, z_new


@register("rmsprop_update", num_outputs=2)
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _prep_grad_wd(grad, weight, rescale_grad, clip_gradient, wd)
    n_new = (1 - gamma1) * torch.square(g) + gamma1 * n
    w = weight - lr * g / torch.sqrt(n_new + epsilon)
    return _clip_weights(w, clip_weights), n_new


@register("rmspropalex_update", num_outputs=4)
def rmspropalex_update(weight, grad, n, g_st, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    g = _prep_grad_wd(grad, weight, rescale_grad, clip_gradient, wd)
    n_new = (1 - gamma1) * torch.square(g) + gamma1 * n
    g_new = (1 - gamma1) * g + gamma1 * g_st
    delta_new = gamma2 * delta - lr * g / torch.sqrt(
        n_new - torch.square(g_new) + epsilon)
    w = weight + delta_new
    return _clip_weights(w, clip_weights), n_new, g_new, delta_new


@register("ftrl_update", num_outputs=3)
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    n_new = n + torch.square(g)
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z_new = z + g - sigma * weight
    w = torch.where(
        torch.abs(z_new) > lamda1,
        -(z_new - torch.sign(z_new) * lamda1)
        / ((beta + torch.sqrt(n_new)) / lr + wd),
        torch.zeros_like(weight))
    return w, z_new, n_new


@register("adagrad_update", num_outputs=2,
          aliases=("_sparse_adagrad_update",))
def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    hist_new = history + torch.square(g)
    return weight - lr * (g / (torch.sqrt(hist_new) + epsilon)
                          + wd * weight), hist_new


@register("adadelta_update", num_outputs=3)
def adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Clip the rescaled gradient without weight decay, then
    ``weight - delta - wd * weight`` (the JAX op, MXNet's Python
    AdaDelta)."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    acc_g_new = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(acc_g_new + epsilon) \
        * g
    acc_delta_new = rho * acc_delta + (1 - rho) * torch.square(delta)
    return weight - delta - wd * weight, acc_g_new, acc_delta_new


def _lars_lr(weight, g, lr, eta, epsilon, wd):
    w_norm = _norm(weight)
    g_norm = _norm(g)
    return torch.where((w_norm > 0) & (g_norm > 0),
                       lr * eta * w_norm / (g_norm + wd * w_norm + epsilon),
                       torch.as_tensor(lr, dtype=w_norm.dtype,
                                       device=w_norm.device))


@register("lars_sgd_update")
def lars_sgd_update(weight, grad, lr=0.01, eta=0.001, epsilon=1e-8, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    """LARS scaling and SGD with the norms on the device."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    lars_lr = _lars_lr(weight, g, lr, eta, epsilon, wd)
    return weight - lars_lr * (g + wd * weight)


@register("lars_sgd_mom_update", num_outputs=2)
def lars_sgd_mom_update(weight, grad, mom, lr=0.01, eta=0.001, epsilon=1e-8,
                        momentum=0.0, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    lars_lr = _lars_lr(weight, g, lr, eta, epsilon, wd)
    mom_new = momentum * mom - lars_lr * (g + wd * weight)
    return weight + mom_new, mom_new


@register("lamb_update_phase1", num_outputs=3)
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * torch.square(g)
    m, v = mean_new, var_new
    if bias_correction:
        m = m / (1 - beta1 ** t)
        v = v / (1 - beta2 ** t)
    return m / (torch.sqrt(v) + epsilon) + wd * weight, mean_new, var_new


@register("lamb_update_phase2")
def lamb_update_phase2(weight, g_update, r1, r2, lr=0.01, lower_bound=-1.0,
                       upper_bound=-1.0):
    if lower_bound is not None and lower_bound > 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1 = torch.clamp(r1, max=upper_bound)
    ratio = torch.where(torch.logical_and(r1 > 0, r2 > 0), r1 / r2,
                        torch.ones_like(r1))
    return weight - lr * ratio * g_update


def _adamw_core(weight32, g, mean, var, lr, beta1, beta2, epsilon, wd, eta,
                rescale):
    """AdamW: decoupled weight decay, no bias correction, the whole update
    skipped when the rescale tensor or a gradient value is not finite
    (the loss scaler's contract)."""
    ok = torch.isfinite(rescale) & torch.all(torch.isfinite(g))
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * torch.square(g)
    step = lr * (mean_new / (torch.sqrt(var_new) + epsilon) + wd * weight32)
    w_new = weight32 - eta * step
    return (torch.where(ok, w_new, weight32), torch.where(ok, mean_new, mean),
            torch.where(ok, var_new, var))


def _adamw_grad(grad, rescale, clip_gradient):
    g = grad * rescale
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register("_adamw_update", num_outputs=3, aliases=("adamw_update",))
def adamw_update(weight, grad, mean, var, rescale_grad, lr=0.001, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 clip_gradient=-1.0):
    """``rescale_grad`` is a tensor input (1 / loss scale); a value that
    is not finite skips the step."""
    rescale = rescale_grad.reshape(())
    g = _adamw_grad(grad, rescale, clip_gradient)
    return _adamw_core(weight, g, mean, var, lr, beta1, beta2, epsilon, wd,
                       eta, rescale)


@register("_mp_adamw_update", num_outputs=4, aliases=("mp_adamw_update",))
def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad,
                    lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                    eta=1.0, clip_gradient=-1.0):
    rescale = rescale_grad.reshape(())
    g = _adamw_grad(_f32(grad), rescale, clip_gradient)
    w32, m, v = _adamw_core(weight32, g, mean, var, lr, beta1, beta2,
                            epsilon, wd, eta, rescale)
    return w32.to(weight.dtype), m, v, w32


@register("mp_nag_mom_update", num_outputs=3)
def mp_nag_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """NAG on the float32 master."""
    g = _prep_grad(_f32(grad), rescale_grad, clip_gradient) + wd * weight32
    mom_new = momentum * mom + g
    w32 = weight32 - lr * (g + momentum * mom_new)
    return w32.to(weight.dtype), mom_new, w32


@register("mp_lamb_update_phase1", num_outputs=3)
def mp_lamb_update_phase1(weight, grad, mean, var, weight32, beta1=0.9,
                          beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0):
    g = _prep_grad(_f32(grad), rescale_grad, clip_gradient)
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * torch.square(g)
    m, v = mean_new, var_new
    if bias_correction:
        m = m / (1 - beta1 ** t)
        v = v / (1 - beta2 ** t)
    return m / (torch.sqrt(v) + epsilon) + wd * weight32, mean_new, var_new


@register("mp_lamb_update_phase2", num_outputs=2)
def mp_lamb_update_phase2(weight, g_update, r1, r2, weight32, lr=0.01,
                          lower_bound=-1.0, upper_bound=-1.0):
    w32 = lamb_update_phase2(weight32, g_update, r1, r2, lr=lr,
                             lower_bound=lower_bound, upper_bound=upper_bound)
    return w32.to(weight.dtype), w32


# ---------------------------------------------- multi-tensor variants ------
# One function over an interleaved tensor list; outputs are the updated
# weights first, then each state kind in weight order (the JAX layout).

def _multi_n(kw):
    # the lamb ops name the count num_tensors, the sgd/adamw ones
    # num_weights
    return int(kw.get("num_weights") or kw.get("num_tensors") or 1)


def _columns(rows):
    """``[(a0, b0), (a1, b1)]`` -> ``(a0, a1, b0, b1)``."""
    return tuple(x for col in zip(*rows) for x in col)


@register("multi_sgd_update", num_outputs=lambda n, kw: _multi_n(kw))
def multi_sgd_update(*args, lrs=(), wds=(), rescale_grad=1.0,
                     clip_gradient=-1.0, num_weights=1):
    """``args = [w0, g0, w1, g1, ...]``."""
    return tuple(sgd_update(args[2 * i], args[2 * i + 1], lr=lrs[i],
                            wd=wds[i], rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient)
                 for i in range(num_weights))


@register("multi_sgd_mom_update", num_outputs=lambda n, kw: 2 * _multi_n(kw))
def multi_sgd_mom_update(*args, lrs=(), wds=(), momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         num_weights=1):
    """``args = [w0, g0, mom0, ...]``; weights then momenta."""
    return _columns(sgd_mom_update(
        *args[3 * i:3 * i + 3], lr=lrs[i], momentum=momentum, wd=wds[i],
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        for i in range(num_weights))


@register("multi_mp_sgd_update", num_outputs=lambda n, kw: 2 * _multi_n(kw))
def multi_mp_sgd_update(*args, lrs=(), wds=(), rescale_grad=1.0,
                        clip_gradient=-1.0, num_weights=1):
    """``args = [w0, g0, w32_0, ...]``; weights then masters."""
    return _columns(mp_sgd_update(
        *args[3 * i:3 * i + 3], lr=lrs[i], wd=wds[i],
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        for i in range(num_weights))


@register("multi_mp_sgd_mom_update",
          num_outputs=lambda n, kw: 3 * _multi_n(kw))
def multi_mp_sgd_mom_update(*args, lrs=(), wds=(), momentum=0.0,
                            rescale_grad=1.0, clip_gradient=-1.0,
                            num_weights=1):
    """``args = [w0, g0, mom0, w32_0, ...]``."""
    return _columns(mp_sgd_mom_update(
        *args[4 * i:4 * i + 4], lr=lrs[i], momentum=momentum, wd=wds[i],
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        for i in range(num_weights))


@register("preloaded_multi_sgd_update",
          num_outputs=lambda n, kw: _multi_n(kw))
def preloaded_multi_sgd_update(*args, rescale_grad=1.0, clip_gradient=-1.0,
                               num_weights=1):
    """``args = [w0, g0, ..., lrs, wds]``: the rates arrive as device
    tensors, so a schedule never leaves the device."""
    lrs, wds = args[-2], args[-1]
    return tuple(sgd_update(args[2 * i], args[2 * i + 1], lr=lrs[i],
                            wd=wds[i], rescale_grad=rescale_grad,
                            clip_gradient=clip_gradient)
                 for i in range(num_weights))


@register("preloaded_multi_sgd_mom_update",
          num_outputs=lambda n, kw: 2 * _multi_n(kw))
def preloaded_multi_sgd_mom_update(*args, momentum=0.0, rescale_grad=1.0,
                                   clip_gradient=-1.0, num_weights=1):
    lrs, wds = args[-2], args[-1]
    return _columns(sgd_mom_update(
        *args[3 * i:3 * i + 3], lr=lrs[i], momentum=momentum, wd=wds[i],
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        for i in range(num_weights))


@register("preloaded_multi_mp_sgd_update",
          num_outputs=lambda n, kw: 2 * _multi_n(kw))
def preloaded_multi_mp_sgd_update(*args, rescale_grad=1.0,
                                  clip_gradient=-1.0, num_weights=1):
    lrs, wds = args[-2], args[-1]
    return _columns(mp_sgd_update(
        *args[3 * i:3 * i + 3], lr=lrs[i], wd=wds[i],
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        for i in range(num_weights))


@register("preloaded_multi_mp_sgd_mom_update",
          num_outputs=lambda n, kw: 3 * _multi_n(kw))
def preloaded_multi_mp_sgd_mom_update(*args, momentum=0.0, rescale_grad=1.0,
                                      clip_gradient=-1.0, num_weights=1):
    lrs, wds = args[-2], args[-1]
    return _columns(mp_sgd_mom_update(
        *args[4 * i:4 * i + 4], lr=lrs[i], momentum=momentum, wd=wds[i],
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)
        for i in range(num_weights))


@register("multi_lars")
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, eta=0.001, eps=1e-8,
               rescale_grad=1.0):
    """Layer-wise LARS rates for a whole parameter set from the per-layer
    sums of squares."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    coef = eta * w_norm / (g_norm + wds * w_norm + eps)
    return lrs * torch.where((w_norm > 0) & (g_norm > 0), coef,
                             torch.ones_like(coef))


@register("_contrib_group_adagrad_update", num_outputs=2,
          aliases=("group_adagrad_update",))
def group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                         clip_gradient=-1.0, epsilon=1e-5):
    """AdaGrad with one accumulator per row."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    axes = tuple(range(1, g.ndim))
    hist_new = history + torch.mean(torch.square(g), dim=axes, keepdim=True) \
        if axes else history + torch.square(g)
    return weight - lr * g / (torch.sqrt(hist_new) + epsilon), hist_new


@register("all_finite", differentiable=False)
def all_finite(data, init_output=True):
    """1.0 when every element is finite, else 0.0 (float32 scalar)."""
    return torch.all(torch.isfinite(data)).to(torch.float32)


_CAST_ORDER = {torch.float16: 0, torch.bfloat16: 0, torch.float32: 1,
               torch.float64: 2}


@register("amp_multicast", num_outputs=lambda n, kw:
          int(kw.get("num_outputs", n or 1)))
def amp_multicast(*args, num_outputs=None, cast_narrow=False):
    """Cast every input to the widest (``cast_narrow``: the narrowest)
    dtype among them."""
    target = args[0].dtype
    for a in args[1:]:
        x, y = _CAST_ORDER.get(a.dtype, 1), _CAST_ORDER.get(target, 1)
        if (x < y) if cast_narrow else (x > y):
            target = a.dtype
    return tuple(a.to(target) for a in args)


@register("reset_arrays", num_outputs=lambda n, kw:
          int(kw.get("num_arrays", n or 1)), differentiable=False)
def reset_arrays(*args, num_arrays=1):
    """Zeroed copies of every input (functional: callers rebind)."""
    return tuple(torch.zeros_like(a) for a in args)


@register("_multi_adamw_update", num_outputs=lambda n, kw: 3 * _multi_n(kw),
          aliases=("multi_adamw_update",))
def multi_adamw_update(*args, lrs=(), wds=(), etas=(), beta1=0.9,
                       beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                       num_weights=1):
    """``args = [w0, g0, mean0, var0, ...] + [rescale_grad]``."""
    rescale = args[-1].reshape(())
    rows = []
    for i in range(num_weights):
        w, g, m, v = args[4 * i:4 * i + 4]
        rows.append(_adamw_core(w, _adamw_grad(g, rescale, clip_gradient),
                                m, v, lrs[i], beta1, beta2, epsilon, wds[i],
                                etas[i], rescale))
    return _columns(rows)


@register("_multi_mp_adamw_update",
          num_outputs=lambda n, kw: 4 * _multi_n(kw),
          aliases=("multi_mp_adamw_update",))
def multi_mp_adamw_update(*args, lrs=(), wds=(), etas=(), beta1=0.9,
                          beta2=0.999, epsilon=1e-8, clip_gradient=-1.0,
                          num_weights=1):
    """``args = [w0, g0, mean0, var0, w32_0, ...] + [rescale_grad]``."""
    rescale = args[-1].reshape(())
    rows = []
    for i in range(num_weights):
        w, g, m, v, w32 = args[5 * i:5 * i + 5]
        w32_2, m2, v2 = _adamw_core(
            w32, _adamw_grad(_f32(g), rescale, clip_gradient), m, v, lrs[i],
            beta1, beta2, epsilon, wds[i], etas[i], rescale)
        rows.append((w32_2.to(w.dtype), m2, v2, w32_2))
    return _columns(rows)


def _lamb_full(w, g, m, v, lr, t, wd, hyper):
    upd, m2, v2 = lamb_update_phase1(
        w, g, m, v, beta1=hyper["beta1"], beta2=hyper["beta2"],
        epsilon=hyper["epsilon"], t=t,
        bias_correction=hyper["bias_correction"], wd=wd,
        rescale_grad=hyper["rescale_grad"],
        clip_gradient=hyper["clip_gradient"])
    w2 = lamb_update_phase2(w, upd, _norm(w), _norm(upd), lr=lr,
                            lower_bound=hyper["lower_bound"],
                            upper_bound=hyper["upper_bound"])
    return w2, m2, v2


@register("_multi_lamb_update", num_outputs=lambda n, kw: 3 * _multi_n(kw),
          aliases=("multi_lamb_update",))
def multi_lamb_update(*args, learning_rates=(), wds=(), beta1=0.9,
                      beta2=0.999, epsilon=1e-6, step_count=(),
                      bias_correction=True, rescale_grad=1.0,
                      lower_bound=-1.0, upper_bound=-1.0,
                      clip_gradient=-1.0, num_tensors=1, num_weights=None):
    """``args = [w0, g0, mean0, var0, ...]``: the whole LAMB step (phase
    1, the trust ratio, phase 2) per tensor."""
    hyper = dict(beta1=beta1, beta2=beta2, epsilon=epsilon,
                 bias_correction=bias_correction, rescale_grad=rescale_grad,
                 lower_bound=lower_bound, upper_bound=upper_bound,
                 clip_gradient=clip_gradient)
    return _columns(_lamb_full(
        *args[4 * i:4 * i + 4], learning_rates[i],
        step_count[i] if step_count else 1, wds[i], hyper)
        for i in range(num_weights or num_tensors))


@register("_multi_mp_lamb_update",
          num_outputs=lambda n, kw: 4 * _multi_n(kw),
          aliases=("multi_mp_lamb_update",))
def multi_mp_lamb_update(*args, learning_rates=(), wds=(), beta1=0.9,
                         beta2=0.999, epsilon=1e-6, step_count=(),
                         bias_correction=True, rescale_grad=1.0,
                         lower_bound=-1.0, upper_bound=-1.0,
                         clip_gradient=-1.0, num_tensors=1,
                         num_weights=None):
    """``args = [w0, g0, mean0, var0, w32_0, ...]``."""
    hyper = dict(beta1=beta1, beta2=beta2, epsilon=epsilon,
                 bias_correction=bias_correction, rescale_grad=rescale_grad,
                 lower_bound=lower_bound, upper_bound=upper_bound,
                 clip_gradient=clip_gradient)
    rows = []
    for i in range(num_weights or num_tensors):
        w, g, m, v, w32 = args[5 * i:5 * i + 5]
        w32_2, m2, v2 = _lamb_full(w32, _f32(g), m, v, learning_rates[i],
                                   step_count[i] if step_count else 1,
                                   wds[i], hyper)
        rows.append((w32_2.to(w.dtype), m2, v2, w32_2))
    return _columns(rows)
