"""AMP: automatic mixed precision.

Counterpart of ``mxnet_tpu/amp/__init__.py`` (MXNet 1.x
``python/mxnet/contrib/amp/amp.py``): ``init`` (:32), ``turn_off``,
``init_trainer`` (:62), ``scale_loss`` (:74), ``unscale`` (:89),
``convert_model`` (:102), ``convert_hybrid_block`` (:131) and the list
helpers. Instead of a graph pass that inserts ``amp_cast`` nodes, the
cast is decided when an op runs (``_amp_core.cast_inputs``, in both
dispatch paths), so a captured graph holds the casts of the state it was
captured under, and ``init``/``turn_off`` make the next call capture
anew (``_amp_core.GEN`` in the compile keys).

The default target is bfloat16, which keeps float32's exponent range:
``init`` makes a loss scaler only for float16. The loss scale enters
through ``Trainer._scale`` (``scale_loss`` divides it by the loss
scale, so the optimizer's ``rescale_grad`` takes it back out), and the
caller calls ``unscale`` after ``backward`` and skips the step when it
reports an overflow, the JAX package's contract. MXNet 1.x skips the
update inside the optimizer instead (ROADMAP C30).
"""
from __future__ import annotations

import contextlib
import warnings

import torch

from .. import _amp_core
from . import lists
from .loss_scaler import LossScaler

__all__ = ["init", "turn_off", "init_trainer", "scale_loss", "unscale",
           "convert_model", "convert_hybrid_block", "list_lp16_ops",
           "list_fp32_ops", "LossScaler"]

_loss_scaler = None
_target_dtype = None


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn AMP on for the process.

    ``target_dtype``: ``"bfloat16"`` (the default) or ``"float16"``;
    ``target_precision_ops`` and ``fp32_ops``: op names added to the
    lists; ``conditional_fp32_ops``: ``[(op, param, values)]``, whose ops
    are cast to float32 whatever the parameter (the JAX package's
    reading, a superset of MXNet's)."""
    global _loss_scaler, _target_dtype
    if target_dtype not in ("bfloat16", "float16"):
        raise ValueError("target_dtype must be bfloat16 or float16")
    target = set(lists.TARGET_OPS) | set(target_precision_ops or [])
    fp32 = set(lists.FP32_OPS) | set(fp32_ops or [])
    for entry in conditional_fp32_ops or []:
        fp32.add(entry[0] if isinstance(entry, (tuple, list)) else entry)
    _amp_core.configure(target_dtype, target - fp32, fp32,
                        set(lists.WIDEST_OPS))
    _target_dtype = target_dtype
    _loss_scaler = LossScaler() if target_dtype == "float16" else None


def turn_off():
    """Turn AMP off; the next call of a captured function captures
    without casts."""
    _amp_core.deactivate()


def init_trainer(optimizer_or_trainer):
    """Attach the dynamic loss scaler to a ``gluon.Trainer`` (nothing for
    bfloat16, which needs none)."""
    if _loss_scaler is None:
        return optimizer_or_trainer
    optimizer_or_trainer._amp_loss_scaler = _loss_scaler
    optimizer_or_trainer._amp_original_scale = \
        getattr(optimizer_or_trainer, "_scale", 1.0)
    return optimizer_or_trainer


@contextlib.contextmanager
def scale_loss(loss, optimizer_or_trainer):
    """Yield the loss times the loss scale, and set the trainer's
    ``_scale`` so that its step divides the scale back out."""
    scaler = getattr(optimizer_or_trainer, "_amp_loss_scaler", None)
    if scaler is None:
        yield loss
        return
    optimizer_or_trainer._scale = (
        optimizer_or_trainer._amp_original_scale / scaler.loss_scale)
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale


def unscale(optimizer_or_trainer):
    """After ``backward``: check the gradients for an overflow (one
    device pass, one read-back) and move the loss scale. Returns True
    when the caller must skip this step."""
    scaler = getattr(optimizer_or_trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return False
    params = [p for p in optimizer_or_trainer._params
              if p.grad_req != "null"]
    overflow = scaler.has_overflow(params)
    scaler.update_scale(overflow)
    return overflow


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  target_dtype_ops=None, fp32_ops=None,
                  conditional_fp32_ops=None, excluded_sym_names=None,
                  cast_optional_params=False):
    """A symbolic model for AMP inference: turns AMP on (the graph's
    casts happen when it runs) and returns ``(sym, arg_params,
    aux_params)``, the parameters float32 unless
    ``cast_optional_params``."""
    init(target_dtype, target_dtype_ops, conditional_fp32_ops, fp32_ops)
    if excluded_sym_names:
        warnings.warn("excluded_sym_names is applied by op name; a node "
                      "cannot be excluded on its own")
    if cast_optional_params:
        dtype = getattr(torch, target_dtype)

        def cast(params):
            return {k: v.astype(dtype) if v.dtype == torch.float32 else v
                    for k, v in params.items()}

        arg_params, aux_params = cast(arg_params), cast(aux_params)
    return sym, arg_params, aux_params


def convert_hybrid_block(block, target_dtype="bfloat16",
                         target_dtype_ops=None, fp32_ops=None,
                         conditional_fp32_ops=None, excluded_sym_names=None,
                         ctx=None, cast_optional_params=False):
    """A HybridBlock for AMP: turns AMP on and hybridizes the block, so
    its next call captures with the casts."""
    init(target_dtype, target_dtype_ops, conditional_fp32_ops, fp32_ops)
    block.hybridize(active=True)
    return block


def list_lp16_ops(target_dtype="bfloat16"):
    return list(lists.TARGET_OPS)


def list_fp32_ops(target_dtype="bfloat16"):
    return list(lists.FP32_OPS)
