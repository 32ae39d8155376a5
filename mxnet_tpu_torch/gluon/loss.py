"""Gluon losses.

Counterpart of ``mxnet_tpu/gluon/loss.py``: the ``Loss`` base (weight,
batch_axis, per-example mean over the non-batch axes),
``_apply_weighting`` with an optional ``sample_weight`` broadcast, and
all twelve losses: ``L2Loss``, ``L1Loss``, ``SigmoidBinaryCrossEntropyLoss``
(logits by default, ``from_sigmoid``, ``pos_weight``),
``SoftmaxCrossEntropyLoss`` (sparse labels by default, a log-softmax
over ``axis`` unless ``from_logits``), ``KLDivLoss``, ``CTCLoss``
(``layout`` NTC/TNC, ``label_layout`` NT/TN, the blank last as in the
JAX layer, so labels pad with -1), ``HuberLoss``, ``HingeLoss``,
``SquaredHingeLoss``, ``LogisticLoss``, ``TripletLoss`` and
``CosineEmbeddingLoss``.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "CosineEmbeddingLoss"]


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


class L1Loss(Loss):
    """``|pred - label|``."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        loss = (pred - label).abs()
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross entropy of a sigmoid: from logits in the stable form
    ``max(x, 0) - x * z + log(1 + exp(-|x|))`` unless ``from_sigmoid``;
    ``pos_weight`` scales the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, pred, label)
        if not self._from_sigmoid:
            relu_p = pred.relu()
            softplus = F.invoke("Activation", -pred.abs(),
                                act_type="softrelu")
            if pos_weight is None:
                loss = relu_p - pred * label + softplus
            else:
                log_wt = (pos_weight - 1) * label + 1
                loss = relu_p - pred * label + softplus * log_wt
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -((pred + eps).log() * label
                         + (1.0 - pred + eps).log() * (1.0 - label))
            else:
                loss = -((pred + eps).log() * label * pos_weight
                         + (1.0 - pred + eps).log() * (1.0 - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` log-probabilities unless
    ``from_logits=False``."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.invoke("log_softmax", pred, axis=self._axis)
        loss = label * ((label + 1e-12).log() - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


class CTCLoss(Loss):
    """Connectionist temporal classification over ``pred`` in ``layout``
    (NTC or TNC) and ``label`` in ``label_layout`` (NT or TN); the blank
    is the last class, so labels pad with -1."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC") or label_layout not in ("NT", "TN"):
            raise ValueError(f"CTCLoss: layout {layout!r}, label_layout "
                             f"{label_layout!r}")
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = pred.swapaxes(0, 1)
        if self._batch_axis == 1:
            label = label.swapaxes(0, 1)
        args = [pred, label]
        kwargs = {"use_data_lengths": pred_lengths is not None,
                  "use_label_lengths": label_lengths is not None,
                  "blank_label": "last"}
        if pred_lengths is not None:
            args.append(pred_lengths)
        if label_lengths is not None:
            args.append(label_lengths)
        loss = F.invoke("CTCLoss", *args, **kwargs)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """``|d| - rho / 2`` beyond ``rho``, ``d^2 / (2 rho)`` within."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        loss = (pred - label).abs()
        loss = F.invoke("where", (loss > self._rho), loss - 0.5 * self._rho,
                        (0.5 / self._rho) * F.invoke("square", loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)``, labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        loss = (self._margin - pred * label).relu()
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


class SquaredHingeLoss(Loss):
    """The square of the hinge loss."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        loss = F.invoke("square", (self._margin - pred * label).relu())
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


class LogisticLoss(Loss):
    """Logistic loss of signed ({-1, 1}) or binary ({0, 1}) labels."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError(f"label_format {label_format!r}")
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = pred.relu() - pred * label + \
            F.invoke("Activation", -pred.abs(), act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return self._mean_all_but_batch(F, loss)


class TripletLoss(Loss):
    """``max(0, |pos - pred|^2 - |neg - pred|^2 + margin)`` per sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(F, pred, positive)
        negative = _reshape_like(F, pred, negative)
        sq = F.invoke("square", positive - pred) - \
            F.invoke("square", negative - pred)
        axes = tuple(range(1, pred.ndim))
        loss = (sq.sum(axis=axes) + self._margin).relu()
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` for similar pairs (label 1), ``max(0, cos - margin)``
    for dissimilar ones (-1)."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        num = (input1 * input2).sum(axis=-1)
        den = input1.norm(axis=-1) * input2.norm(axis=-1) + 1e-12
        sim = num / den
        label = label.reshape(sim.shape)
        loss = F.invoke("where", label == 1.0, 1.0 - sim,
                        (sim - self._margin).relu())
        return _apply_weighting(F, loss, self._weight, sample_weight)
