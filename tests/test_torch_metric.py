"""The port's metrics (mxnet_tpu_torch/metric.py) against the JAX
package's on the CPU, on the inputs of the JAX package's own
``tests/test_metric.py`` and on random batches from a seed: the same
``get()``, ``get_global()`` after a ``reset_local()`` and
``get_name_value()``, to rtol 1e-6 (the port's Accuracy and
TopKAccuracy count on the predictions' device; the others compute in
numpy as the JAX package's do)."""
import logging
import math

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import metric as jmetric
from mxnet_tpu_torch import metric

CPU = mx.cpu()
RTOL = 1e-6


def _rs(seed):
    return np.random.RandomState(seed)


def _probs(rs, n, c):
    p = rs.rand(n, c).astype(np.float32) + 0.05
    return p / p.sum(axis=1, keepdims=True)


# (metric name, kwargs, [(labels, preds), ...] as numpy arrays)
CASES = [
    ("acc", {}, [([np.array([1, 0, 0], np.float32)],
                  [np.array([[0.3, 0.7], [0.9, 0.1], [0.4, 0.6]],
                            np.float32)])]),
    ("accuracy", {}, [([np.array([[1], [0]], np.float32)],
                       [np.array([[0.3, 0.7], [0.9, 0.1]], np.float32)])]),
    ("accuracy", {"axis": 1}, [
        ([_rs(0).randint(0, 5, 16).astype(np.float32)], [_probs(_rs(1), 16, 5)]),
        ([_rs(2).randint(0, 5, 16).astype(np.float32)], [_probs(_rs(3), 16, 5)])]),
    ("accuracy", {}, [([np.array([1, 2, 0], np.int32)],
                       [np.array([1, 2, 1], np.float32)])]),
    ("top_k_accuracy", {"top_k": 2}, [
        ([np.array([1, 1], np.float32)],
         [np.array([[0.1, 0.2, 0.7], [0.6, 0.3, 0.1]], np.float32)]),
        ([np.array([1, 2], np.float32)],
         [np.array([[0.1, 0.2, 0.7], [0.6, 0.3, 0.1]], np.float32)])]),
    ("top_k_acc", {"top_k": 3}, [
        ([_rs(4).randint(0, 6, 12).astype(np.float32)],
         [_probs(_rs(5), 12, 6)])]),
    ("f1", {}, [([np.array([0, 1, 1, 1], np.float32)],
                 [np.array([[0.7, 0.3], [0.2, 0.8], [0.1, 0.9], [0.6, 0.4]],
                           np.float32)])]),
    ("f1", {"average": "micro"}, [
        ([_rs(6).randint(0, 2, 10).astype(np.float32)],
         [_probs(_rs(7), 10, 2)]),
        ([_rs(8).randint(0, 2, 10).astype(np.float32)],
         [_probs(_rs(9), 10, 2)])]),
    ("mcc", {}, [([np.array([0, 1, 1, 1], np.float32)],
                  [np.array([[0.7, 0.3], [0.2, 0.8], [0.1, 0.9],
                             [0.6, 0.4]], np.float32)])]),
    ("mcc", {"average": "micro"}, [
        ([_rs(10).randint(0, 2, 10).astype(np.float32)],
         [_probs(_rs(11), 10, 2)])]),
    ("mae", {}, [([np.array([1.5, 2.0, 2.5], np.float32)],
                  [np.array([1.0, 2.0, 3.0], np.float32)])]),
    ("mse", {}, [([np.array([1.5, 2.0, 2.5], np.float32)],
                  [np.array([1.0, 2.0, 3.0], np.float32)])]),
    ("rmse", {}, [([np.array([1.5, 2.0, 2.5], np.float32)],
                   [np.array([1.0, 2.0, 3.0], np.float32)]),
                  ([_rs(12).randn(4, 2).astype(np.float32)],
                   [_rs(13).randn(4, 2).astype(np.float32)])]),
    ("ce", {}, [([np.array([1, 0], np.float32)],
                 [np.array([[0.25, 0.75], [0.5, 0.5]], np.float32)])]),
    ("crossentropy", {"eps": 1e-8}, [
        ([_rs(14).randint(0, 4, 9).astype(np.float32)],
         [_probs(_rs(15), 9, 4)])]),
    ("nll_loss", {}, [([_rs(16).randint(0, 4, 9).astype(np.float32)],
                       [_probs(_rs(17), 9, 4)])]),
    ("perplexity", {}, [([np.array([1, 0], np.float32)],
                         [np.array([[0.25, 0.75], [0.5, 0.5]], np.float32)])]),
    ("perplexity", {"ignore_label": 2}, [
        ([_rs(18).randint(0, 4, 9).astype(np.float32)],
         [_probs(_rs(19), 9, 4)])]),
    ("perplexity", {"axis": 1}, [
        ([np.array([[1, 0]], np.float32)],
         [np.moveaxis(np.array([[[0.25, 0.75], [0.5, 0.5]]], np.float32),
                      -1, 1)])]),
    ("pearsonr", {}, [([np.array([2.0, 4.0, 6.0, 8.0], np.float32)],
                       [np.array([1.0, 2.0, 3.0, 4.0], np.float32)]),
                      ([_rs(20).randn(7).astype(np.float32)],
                       [_rs(21).randn(7).astype(np.float32)])]),
    ("loss", {}, [(None, [np.array([1.0, 2.0, 3.0], np.float32)]),
                  (None, [_rs(22).rand(5).astype(np.float32)])]),
]


def _feed(nd, ctx, arrays):
    if arrays is None:
        return None
    kw = {"ctx": ctx} if ctx is not None else {}
    return [nd.array(a, **kw) for a in arrays]


def _compare(got, want):
    (gn, gv), (wn, wv) = got, want
    assert gn == wn
    gv, wv = np.atleast_1d(gv), np.atleast_1d(wv)
    assert np.allclose(gv.astype(float), wv.astype(float), rtol=RTOL,
                       atol=0, equal_nan=True), (gv, wv)


@pytest.mark.parametrize("name,kw,updates", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_metric_matches_jax(name, kw, updates):
    m, jm = metric.create(name, **kw), jmetric.create(name, **kw)
    assert type(m).__name__ == type(jm).__name__
    assert m.name == jm.name
    _compare(m.get(), jm.get())     # nan before any update
    for i, (labels, preds) in enumerate(updates):
        m.update(_feed(mx.nd, CPU, labels), _feed(mx.nd, CPU, preds))
        jm.update(_feed(jmx.nd, None, labels), _feed(jmx.nd, None, preds))
        _compare(m.get(), jm.get())
        if i == 0:
            m.reset_local()
            jm.reset_local()
            _compare(m.get(), jm.get())
    _compare(m.get_global(), jm.get_global())
    assert [n for n, _ in m.get_name_value()] == \
        [n for n, _ in jm.get_name_value()]
    assert m.get_config() == jm.get_config()
    m.reset()
    assert math.isnan(m.get()[1])


def test_composite_custom_and_registry_match_jax():
    pred = [np.array([[0.3, 0.7], [0.8, 0.2]], np.float32)]
    label = [np.array([1, 1], np.float32)]
    comp, jcomp = metric.create(["acc", "mae"]), jmetric.create(["acc", "mae"])
    assert isinstance(comp, metric.CompositeEvalMetric)
    comp.update(_feed(mx.nd, CPU, label), _feed(mx.nd, CPU, pred))
    jcomp.update(_feed(jmx.nd, None, label), _feed(jmx.nd, None, pred))
    assert comp.get()[0] == jcomp.get()[0] == ["accuracy", "mae"]
    np.testing.assert_allclose(comp.get()[1], jcomp.get()[1], rtol=RTOL)
    np.testing.assert_allclose([v for _, v in comp.get_global_name_value()],
                               [v for _, v in jcomp.get_global_name_value()],
                               rtol=RTOL)
    assert comp.get_metric(1).name == "mae"

    def feval(lab, p):
        return float(np.abs(lab - p.argmax(1)).sum())

    for make, jmake in ((lambda: metric.np(feval), lambda: jmetric.np(feval)),
                        (lambda: metric.create(feval),
                         lambda: jmetric.create(feval)),
                        (lambda: metric.CustomMetric(
                            lambda lab, p: (3.0, 2), name="pair"),
                         lambda: jmetric.CustomMetric(
                             lambda lab, p: (3.0, 2), name="pair"))):
        m, jm = make(), jmake()
        m.update(_feed(mx.nd, CPU, label), _feed(mx.nd, CPU, pred))
        jm.update(_feed(jmx.nd, None, label), _feed(jmx.nd, None, pred))
        assert m.get() == jm.get()
    assert str(metric.create("acc")) == "EvalMetric: {'accuracy': nan}"
    with pytest.raises(ValueError):
        metric.create("unknown_metric")
    with pytest.raises(ValueError):
        metric.Accuracy().update(_feed(mx.nd, CPU, label),
                                 _feed(mx.nd, CPU, pred * 2))


def test_update_dict_picks_outputs_and_labels_by_name():
    m = metric.Accuracy(output_names=["sm_output"],
                        label_names=["softmax_label"])
    pred = mx.nd.array([[0.3, 0.7], [0.9, 0.1]], ctx=CPU)
    m.update_dict({"softmax_label": mx.nd.array([1, 1], ctx=CPU)},
                  {"sm_output": pred, "other": pred})
    assert m.get() == ("accuracy", 0.5)


def test_accuracy_copies_indices_not_probabilities(monkeypatch):
    """One host copy a batch, of the argmax and the labels."""
    import torch

    copies = []
    real = torch.Tensor.cpu

    def spy(t, *a, **k):
        copies.append(t.numel())
        return real(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    pred = mx.nd.array(_probs(_rs(23), 64, 1000), ctx=CPU)
    label = mx.nd.array(_rs(24).randint(0, 1000, 64).astype(np.float32),
                        ctx=CPU)
    for m in (metric.Accuracy(), metric.TopKAccuracy(top_k=5)):
        copies.clear()
        m.update([label], [pred])
        assert len(copies) == 1 and copies[0] <= 64 * 6, copies


def test_speedometer_and_callbacks_log_as_jax(caplog, tmp_path):
    """Speedometer, log_train_metric, ProgressBar and
    LogValidationMetricsCallback write the JAX package's lines (speeds
    masked); do_checkpoint and module_checkpoint write their files."""
    import re
    from mxnet_tpu import callback as jcallback
    from mxnet_tpu_torch import callback

    lines = {}
    for pkg, cb, nd, ctx in (("port", callback, mx.nd, CPU),
                             ("jax", jcallback, jmx.nd, None)):
        m = (metric if pkg == "port" else jmetric).create("acc")
        label = _feed(nd, ctx, [np.array([1, 0], np.float32)])
        pred = _feed(nd, ctx, [np.array([[0.2, 0.8], [0.6, 0.4]],
                                        np.float32)])
        cbs = [cb.Speedometer(2, 2), cb.Speedometer(2, 2, auto_reset=False),
               cb.log_train_metric(2), cb.ProgressBar(4),
               cb.LogValidationMetricsCallback()]
        caplog.clear()
        with caplog.at_level(logging.INFO):
            for nbatch in range(5):
                m.update(label, pred)
                param = (mx if pkg == "port" else jmx).model.BatchEndParam(
                    epoch=1, nbatch=nbatch, eval_metric=m, locals=None)
                for c in cbs:
                    c(param)
        lines[pkg] = [re.sub(r"Speed: [0-9.inf]+", "Speed: S", r.getMessage())
                      for r in caplog.records]
    assert lines["port"] == lines["jax"]
    assert any("Speed: S samples/sec\taccuracy=" in ln for ln in lines["port"])
