"""Gluon losses.

Counterpart of ``mxnet_tpu/gluon/loss.py:18-125``: the ``Loss`` base
(weight, batch_axis, per-example mean over the non-batch axes),
``_apply_weighting`` with an optional ``sample_weight`` broadcast,
``L2Loss`` and ``SoftmaxCrossEntropyLoss`` (sparse labels by default, a
log-softmax over ``axis`` unless ``from_logits``). The other losses of the
JAX package are not ported yet.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.invoke("broadcast_mul", loss, sample_weight)
    if weight is not None:
        assert isinstance(weight, (int, float)), "weight must be a number"
        loss = loss * weight
    return loss


def _reshape_like(F, pred, label):
    return label.reshape(pred.shape) if pred.shape != label.shape else label


class Loss(HybridBlock):
    """Base loss: ``weight`` scales it, ``batch_axis`` is kept when the
    per-example mean is taken."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return f"{type(self).__name__}(batch_axis={self._batch_axis}, " \
               f"w={self._weight})"

    def _mean_all_but_batch(self, F, loss):
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        return loss.mean(axis=axes) if axes else loss


class L2Loss(Loss):
    """``weight / 2 * (pred - label)^2``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        loss = F.invoke("square", pred - label)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return self._mean_all_but_batch(F, loss)


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy of a softmax over ``axis``: sparse labels (class
    ids, as floats or integers) by default, else one distribution per
    row."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.invoke("log_softmax", pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.invoke("pick", pred, label, axis=self._axis,
                             keepdims=True)
        else:
            label = _reshape_like(F, pred, label)
            loss = -(pred * label).sum(axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
