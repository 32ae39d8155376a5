"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (MXNet 1.x
``python/mxnet/metric.py``): the ``EvalMetric`` base with its registry
(``register``, ``alias``, ``create``), ``CompositeEvalMetric``,
``Accuracy``, ``TopKAccuracy``, ``F1``, ``MCC``, ``Perplexity``,
``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``, ``NegativeLogLikelihood``,
``PearsonCorrelation``, ``Loss``, ``CustomMetric`` and ``np``.

The metrics compute on the host in numpy, as MXNet 1.x's do after
``asnumpy``, except ``Accuracy`` and ``TopKAccuracy``: they take the
argmax (top k) of the predictions on the predictions' device and move
only those indices and the labels to the host, in one copy: one wait
for the device a batch, and a few hundred bytes instead of the
probabilities.
"""
from __future__ import annotations

import math

import numpy
import torch

from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss",
           "CustomMetric", "create", "np", "check_label_shapes"]

_registry = {}


def register(klass):
    _registry[klass.__name__.lower()] = klass
    return klass


def alias(*aliases):
    def deco(klass):
        for a in aliases:
            _registry[a.lower()] = klass
        return klass

    return deco


def create(metric, *args, **kwargs):
    """A metric from a registered name, a callable (``CustomMetric``), a
    list (``CompositeEvalMetric``) or a metric (returned as is)."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, CompositeEvalMetric):
        return metric
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        if metric.lower() not in _registry:
            raise ValueError(f"metric {metric} is not registered; known: "
                             f"{sorted(_registry)}")
        return _registry[metric.lower()](*args, **kwargs)
    raise TypeError(f"cannot create metric from {metric!r}")


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Raise unless labels and predictions agree in count (or, with
    ``shape``, in shape); with ``wrap`` a single array becomes a list."""
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(
            f"Shape of labels {label_shape} does not match shape of "
            f"predictions {pred_shape}")
    if wrap:
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
    return labels, preds


def _as_numpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


def _as_tensor(x):
    return x._data.detach() if isinstance(x, NDArray) else \
        torch.as_tensor(numpy.asarray(x))


def _to_host(*tensors):
    """The int64 tensors (on one device) on the host, in one copy."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(host[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


class EvalMetric:
    """Base metric: a name, the running sum and count of the window
    (``get``) and of the epoch (``get_global``)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"

    def get_config(self):
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        """Reset only the windowed (local) statistics, folding them into the
        epoch-global counters."""
        self.global_sum_metric += self.sum_metric
        self.global_num_inst += self.num_inst
        self.num_inst = 0
        self.sum_metric = 0.0

    def _compute(self, total, num):
        """Value from accumulated (total, num) — overridden by metrics whose
        get() applies a transform (RMSE sqrt, Perplexity exp), so that
        get() and get_global() stay consistent."""
        return total / num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self._compute(self.sum_metric, self.num_inst))

    def get_global(self):
        """Epoch-global value including the current window."""
        num = getattr(self, "global_num_inst", 0) + self.num_inst
        total = getattr(self, "global_sum_metric", 0.0) + self.sum_metric
        if num == 0:
            return (self.name, float("nan"))
        return (self.name, self._compute(total, num))

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def get_global_name_value(self):
        name, value = self.get_global()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; their names and values as lists."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def reset_local(self):
        for metric in getattr(self, "metrics", []):
            metric.reset_local()

    def _gather(self, getter):
        names, values = [], []
        for metric in self.metrics:
            name, value = getter(metric)
            if isinstance(name, str):
                name = [name]
            if not isinstance(value, list):
                value = [value]
            names.extend(name)
            values.extend(value)
        return names, values

    def get(self):
        return self._gather(lambda m: m.get())

    def get_global(self):
        return self._gather(lambda m: m.get_global())


@register
@alias("acc")
class Accuracy(EvalMetric):
    """The share of predictions whose argmax over ``axis`` equals the label."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            pred = _as_tensor(pred)
            label = _as_tensor(label).to(pred.device)
            # argmax whenever the shapes differ ((N, 1) column labels
            # against (N, C) predictions too)
            if tuple(pred.shape) != tuple(label.shape):
                pred = pred.argmax(dim=self.axis)
            # MXNet's astype("int32"): truncation toward zero
            pred, label = _to_host(pred.to(torch.int32).to(torch.int64),
                                   label.to(torch.int32).to(torch.int64))
            pred, label = pred.reshape(-1), label.reshape(-1)
            check_label_shapes(label, pred)
            self.sum_metric += (pred == label).sum()
            self.num_inst += len(pred)


@register
@alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    """The share of labels among the ``top_k`` largest predictions."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert self.top_k > 1, "Use Accuracy if top_k == 1"
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            pred = _as_tensor(pred).to(torch.float32)
            assert pred.ndim == 2, "Predictions should be 2 dims"
            num_samples, num_classes = pred.shape
            top_k = min(num_classes, self.top_k)
            top = pred.topk(top_k, dim=-1).indices
            label = _as_tensor(label).to(pred.device).to(torch.int32)
            top, label = _to_host(top, label.to(torch.int64).reshape(-1))
            self.sum_metric += (top == label[:, None]).sum()
            self.num_inst += num_samples


class _BinaryClassificationHelper:
    """Confusion-matrix accumulator."""

    def __init__(self):
        self.reset_stats()

    def reset_stats(self):
        self.true_positives = 0
        self.false_positives = 0
        self.true_negatives = 0
        self.false_negatives = 0

    def update_binary_stats(self, label, pred):
        pred_label = numpy.argmax(pred, axis=1)
        check_label_shapes(label, pred_label)
        if len(numpy.unique(label)) > 2:
            raise ValueError("label must be binary")
        pred_true = pred_label == 1
        pred_false = ~pred_true
        label_true = label == 1
        label_false = ~label_true
        self.true_positives += (pred_true & label_true).sum()
        self.false_positives += (pred_true & label_false).sum()
        self.false_negatives += (pred_false & label_true).sum()
        self.true_negatives += (pred_false & label_false).sum()

    @property
    def precision(self):
        denom = self.true_positives + self.false_positives
        return self.true_positives / denom if denom > 0 else 0.0

    @property
    def recall(self):
        denom = self.true_positives + self.false_negatives
        return self.true_positives / denom if denom > 0 else 0.0

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return 2 * self.precision * self.recall / (self.precision + self.recall)
        return 0.0

    @property
    def matthewscc(self):
        terms = [(self.true_positives + self.false_positives),
                 (self.true_positives + self.false_negatives),
                 (self.true_negatives + self.false_positives),
                 (self.true_negatives + self.false_negatives)]
        denom = 1.0
        for t in terms:
            denom *= max(float(t), 1.0)
        return ((self.true_positives * self.true_negatives
                 - self.false_positives * self.false_negatives)
                / math.sqrt(denom))

    @property
    def total_examples(self):
        return (self.true_positives + self.false_positives
                + self.true_negatives + self.false_negatives)

    def absorb(self, other):
        """Fold another accumulator's counts into this one, resetting it
        (used by reset_local to bank the window into the epoch-global)."""
        self.true_positives += other.true_positives
        self.false_positives += other.false_positives
        self.true_negatives += other.true_negatives
        self.false_negatives += other.false_negatives
        other.reset_stats()

    def combined(self, other):
        c = _BinaryClassificationHelper()
        c.true_positives = self.true_positives + other.true_positives
        c.false_positives = self.false_positives + other.false_positives
        c.true_negatives = self.true_negatives + other.true_negatives
        c.false_negatives = self.false_negatives + other.false_negatives
        return c


@register
class F1(EvalMetric):
    """F1 score of binary predictions (``average`` ``"macro"`` over batches, or ``"micro"``)."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationHelper()
        self.global_metrics = _BinaryClassificationHelper()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(_as_numpy(label).astype("int32"),
                                             _as_numpy(pred))
            if self.average == "macro":
                self.sum_metric += self.metrics.fscore
                self.num_inst += 1
                self.metrics.reset_stats()

    def get(self):
        if self.average == "micro":
            if self.metrics.total_examples == 0:
                return (self.name, float("nan"))
            return (self.name, self.metrics.fscore)
        return super().get()

    def get_global(self):
        if self.average == "micro":
            comb = self.global_metrics.combined(self.metrics)
            if comb.total_examples == 0:
                return (self.name, float("nan"))
            return (self.name, comb.fscore)
        return super().get_global()

    def reset(self):
        super().reset()
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()
            self.global_metrics.reset_stats()

    def reset_local(self):
        super().reset_local()
        if hasattr(self, "metrics"):
            self.global_metrics.absorb(self.metrics)


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationHelper()
        self.global_metrics = _BinaryClassificationHelper()
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(_as_numpy(label).astype("int32"),
                                             _as_numpy(pred))
            if self.average == "macro":
                self.sum_metric += self.metrics.matthewscc
                self.num_inst += 1
                self.metrics.reset_stats()

    def get(self):
        if self.average == "micro":
            if self.metrics.total_examples == 0:
                return (self.name, float("nan"))
            return (self.name, self.metrics.matthewscc)
        return super().get()

    def get_global(self):
        if self.average == "micro":
            comb = self.global_metrics.combined(self.metrics)
            if comb.total_examples == 0:
                return (self.name, float("nan"))
            return (self.name, comb.matthewscc)
        return super().get_global()

    def reset(self):
        super().reset()
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()
            self.global_metrics.reset_stats()

    def reset_local(self):
        super().reset_local()
        if hasattr(self, "metrics"):
            self.global_metrics.absorb(self.metrics)


@register
class Perplexity(EvalMetric):
    """``exp`` of the mean negative log-probability of the labels."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label, axis=axis)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if self.axis not in (-1, pred.ndim - 1):
                pred = numpy.moveaxis(pred, self.axis, -1)
            label = label.reshape(-1).astype("int64")
            probs = pred.reshape(-1, pred.shape[-1])[
                numpy.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = numpy.where(ignore, 1.0, probs)
                num -= ignore.sum()
            loss -= numpy.log(numpy.maximum(1e-10, probs)).sum()
            num += label.size
        self.sum_metric += loss
        self.num_inst += num

    def _compute(self, total, num):
        return math.exp(total / num)


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += numpy.abs(label - pred).mean()
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _compute(self, total, num):
        return math.sqrt(total / num)


@register
@alias("ce")
class CrossEntropy(EvalMetric):
    """The mean of ``-log(p[label] + eps)``."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@register
@alias("nll_loss")
class NegativeLogLikelihood(EvalMetric):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred)
            num_examples = pred.shape[0]
            assert label.shape[0] == num_examples
            prob = pred[numpy.arange(num_examples), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += num_examples


@register
@alias("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, wrap=True)
        for label, pred in zip(labels, preds):
            label = _as_numpy(label).ravel()
            pred = _as_numpy(pred).ravel()
            check_label_shapes(label, pred)
            self.sum_metric += numpy.corrcoef(pred, label)[0, 1]
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Mean of raw loss values."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            arr = _as_numpy(pred)
            self.sum_metric += arr.sum()
            self.num_inst += arr.size


@register
class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` on numpy arrays, returning a value or ``(sum, count)``."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names, feval=feval,
                         allow_extra_outputs=allow_extra_outputs)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, wrap=True)
        else:
            if isinstance(labels, NDArray):
                labels = [labels]
            if isinstance(preds, NDArray):
                preds = [preds]
        for pred, label in zip(preds, labels):
            label = _as_numpy(label)
            pred = _as_numpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A :class:`CustomMetric` from a numpy function."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
