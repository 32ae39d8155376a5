"""Loss-head output ops with MXNet's hand-written gradients.

Counterpart of ``mxnet_tpu/ops/output_ops.py`` (:21-132):
``LinearRegressionOutput``, ``MAERegressionOutput`` and
``LogisticRegressionOutput`` (``regression_output.cc``), ``SVMOutput``
(``svm_output.cc``) and ``IdentityAttachKLSparseReg``
(``identity_attach_KL_sparse_reg.cc``). Each is a
``torch.autograd.Function`` whose backward is the JAX op's
``custom_vjp`` backward: the head's forward is the prediction, and its
backward ignores the head gradient and injects the loss gradient (the
KL op adds its penalty to the head gradient). Labels get no gradient.
"""
from __future__ import annotations

import torch

from .nn import _one_hot
from .registry import register

__all__ = []


def _make_regression_output(name, fwd_fn, grad_fn):
    class _Head(torch.autograd.Function):
        @staticmethod
        def forward(ctx, data, label, grad_scale):
            out = fwd_fn(data)
            ctx.save_for_backward(out, label)
            ctx.grad_scale = grad_scale
            return out

        @staticmethod
        def backward(ctx, cot):
            out, label = ctx.saved_tensors
            # MXNet divides by the outputs per sample
            # (regression_output-inl.h: grad_scale / num_output)
            num_output = out.numel() // out.shape[0] if out.ndim > 0 else 1
            g = grad_fn(out, label) * (ctx.grad_scale / num_output)
            return g.to(out.dtype), None, None

    def op(data, label, grad_scale=1.0):
        """Regression head: the prediction forward, the loss gradient
        scaled by ``grad_scale`` over the outputs per sample backward."""
        lab = label.reshape(data.shape) if label.numel() == data.numel() \
            else label
        return _Head.apply(data, lab, grad_scale)

    op.__name__ = name
    register(name)(op)


_make_regression_output("LinearRegressionOutput", torch.clone,
                        lambda out, label: out - label)
_make_regression_output("MAERegressionOutput", torch.clone,
                        lambda out, label: torch.sign(out - label))
_make_regression_output("LogisticRegressionOutput", torch.sigmoid,
                        lambda out, label: out - label)


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg_coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.hyper = (margin, reg_coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, cot):
        """The L1 (``use_linear``) or L2 hinge gradient of the true
        class's margin against every other class."""
        data, label = ctx.saved_tensors
        margin, reg_coef, use_linear = ctx.hyper
        onehot = _one_hot(label, data.shape[-1], data.dtype)
        score_true = (data * onehot).sum(dim=-1, keepdim=True)
        viol = margin - (score_true - data)
        viol = torch.where(onehot > 0, torch.zeros_like(viol), viol)
        if use_linear:
            g_other = (viol > 0).to(data.dtype) * reg_coef
        else:
            g_other = torch.clamp(viol, min=0.0) * 2.0 * reg_coef
        g_true = -g_other.sum(dim=-1, keepdim=True)
        g = g_other + g_true * onehot
        return g.to(data.dtype), None, None, None, None


@register("SVMOutput")
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    """SVM head: the scores forward; the hinge-loss gradient backward."""
    return _SVMOutput.apply(data, label, margin, regularization_coefficient,
                            use_linear)


class _KLSparseReg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, sparseness_target, penalty):
        ctx.save_for_backward(data)
        ctx.hyper = (sparseness_target, penalty)
        return data.clone()

    @staticmethod
    def backward(ctx, cot):
        """The head gradient plus the KL sparsity penalty's gradient on
        each unit's mean activation over the batch."""
        (data,) = ctx.saved_tensors
        rho, penalty = ctx.hyper
        rho_hat = torch.clamp(data.mean(dim=0, keepdim=True), 1e-6,
                              1 - 1e-6)
        kl_grad = penalty * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))
        return (cot + kl_grad / data.shape[0]).to(data.dtype), None, None


@register("IdentityAttachKLSparseReg")
def _identity_attach_kl(data, sparseness_target=0.1, penalty=0.001,
                        momentum=0.9):
    """Identity forward that attaches a KL sparsity penalty's gradient
    on the mean activation. ``momentum`` is accepted, as in the JAX op,
    and unused."""
    return _KLSparseReg.apply(data, sparseness_target, penalty)
