"""Optimizer update steps as ops: the plain versions of the fused kernels.

Counterpart of ``mxnet_tpu/ops/optimizer_op.py`` (``sgd_update`` :46,
``sgd_mom_update`` :53, ``adam_update`` :104, with the gradient prep of
:25-43). Each is a function of tensors returning new tensors, written op
for op in the JAX ops' order, so that PyTorch (which rounds after every
op and never contracts ``a*b+c``) gives the IEEE results that the CUDA
kernels of ``kernels/opt_step.py`` reproduce bit for bit. ``lr`` may be a
Python float or a float32 0-dim tensor (the device scalar the kernels
read).
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


@register("sgd_update")
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


@register("sgd_mom_update")
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    mom_new = momentum * mom - lr * (g + wd * weight)
    return weight + mom_new, mom_new


@register("adam_update")
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _prep_grad_wd(grad, weight, rescale_grad, clip_gradient, wd)
    mean_new = beta1 * mean + (1 - beta1) * g
    var_new = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - lr * mean_new / (torch.sqrt(var_new) + epsilon)
    return w, mean_new, var_new
