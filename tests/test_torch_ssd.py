"""MXNet 1.x's SSD (``example/ssd``: ``common.py``'s feature and multibox
layers, ``symbol_builder.get_symbol_train``, ``train_net.py``'s
``Module.fit``, ``train/metric.py``) built by ``chip_smoke.py``'s
``ssd_*`` functions on a narrow backbone (three conv-ReLU layers, 64 x 64
input, two feature layers from the backbone and one extra), held on the
CPU:

* the forward outputs (``cls_prob``, ``loc_loss``, ``cls_label``, ``det``)
  against the JAX package's executor over the same graph (the port's JSON
  loaded there) and the same seeded weights and batch;
* the symbol JSON both ways (the port's through the JAX package and back,
  the tuple attributes kept);
* every parameter's gradient against ``torch.autograd`` of the SSD loss
  written out in plain torch (the softmax cross-entropy of the valid class
  targets over their count, plus the smooth-L1 sum over the count of its
  nonzero terms): the JAX ``MakeLoss`` is the identity (fault C17), so the
  gradient has no JAX reference;
* one ``Module.fit`` batch as ``train_net.py`` wires it, and the
  detections' rows.

Tolerances: outputs at rtol 1e-5, atol 1e-5; gradients at rtol 1e-4, atol
1e-6.
"""
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
CFG = {"batch": 2, "data_shape": 64, "num_classes": 3, "max_objects": 4,
       "num_filters": (-1, -1, 32), "strides": (-1, -1, 2),
       "pads": (-1, -1, 1), "sizes": ((.2, .3), (.4, .5), (.6, .8)),
       "ratios": ((1, 2, .5), (1, 2, .5, 3, 1. / 3), (1, 2, .5)),
       "nms_thresh": 0.45, "nms_topk": 20}


def _body(m):
    """Three conv-ReLU layers: strides 2, 4 and 8 (32, 16 and 8 pixels a
    side at 64)."""
    x = m.sym.var("data")
    for i, (f, s) in enumerate(((8, 2), (16, 2), (16, 2))):
        x = m.sym.Convolution(x, kernel=(3, 3), pad=(1, 1), stride=(s, s),
                              num_filter=f, name=f"body{i}")
        x = m.sym.Activation(x, act_type="relu", name=f"body{i}_relu")
    return x


def _layers(m):
    return cs.ssd_multi_layer_feature(
        m, _body(m), ["body1_relu", "body2_relu", ""], CFG["num_filters"],
        CFG["strides"], CFG["pads"], min_filter=16)


def _train_symbol(m=mx):
    return cs.ssd_symbol_train(m, _layers(m), CFG["num_classes"],
                               CFG["sizes"], CFG["ratios"],
                               nms_thresh=CFG["nms_thresh"],
                               nms_topk=CFG["nms_topk"])


def _shapes():
    s = CFG["data_shape"]
    return {"data": (CFG["batch"], 3, s, s),
            "label": (CFG["batch"], CFG["max_objects"], 5)}


def _batch(seed=0):
    return cs.ssd_batch(CFG["batch"], CFG["data_shape"], CFG["num_classes"],
                        CFG["max_objects"], seed)


def _weights(names_shapes, seed=1):
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * (0.1 if n.endswith("weight") else 0.01))
            .astype(np.float32) for n, s in names_shapes}


def _bound(sym, jsym=None, grad_req="write"):
    shapes = _shapes()
    ex = sym.simple_bind(mx.cpu(), grad_req=grad_req, **shapes)
    params = _weights([(n, a.shape) for n, a in ex.arg_dict.items()
                       if n not in shapes])
    x, y = _batch()
    for n, v in dict(params, data=x, label=y).items():
        ex.arg_dict[n]._data.copy_(torch.from_numpy(v))
    jex = None
    if jsym is not None:
        jex = jsym.simple_bind(jmx.cpu(), grad_req="null", **shapes)
        for n, v in dict(params, data=x, label=y).items():
            jex.arg_dict[n]._rebind(jmx.nd.array(v)._data)
    return ex, jex, params


def test_the_ssd_has_its_anchor_count_and_outputs():
    sym = _train_symbol()
    assert sym.list_outputs() == ["cls_prob_output", "loc_loss_output",
                                  "cls_label_output", "det_out_output"]
    _, outs, _ = sym.infer_shape(**_shapes())
    n = 16 * 16 * 4 + 8 * 8 * 6 + 4 * 4 * 4
    assert outs == [(2, 4, n), (2, n * 4), (2, n), (2, n, 6)]


def test_forward_outputs_match_jax():
    sym = _train_symbol()
    jsym = jmx.sym.load_json(sym.tojson())
    ex, jex, _ = _bound(sym, jsym)
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    jouts = [o.asnumpy() for o in jex.forward(is_train=True)]
    assert len(outs) == len(jouts) == 4
    for got, want in zip(outs, jouts):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
    cls_label, det = outs[2], outs[3]
    assert (cls_label > 0).any() and (cls_label == 0).any() and \
        (cls_label == -1).any()
    ok, kept = cs.valid_detections(det)
    assert ok and min(kept) > 0
    # suppressed rows are all -1, in both packages
    np.testing.assert_array_equal((det == -1).all(-1),
                                  (jouts[3] == -1).all(-1))


def test_symbol_json_round_trips_both_ways():
    sym = _train_symbol()
    jsym = jmx.sym.load_json(sym.tojson())
    back = mx.sym.load_json(jsym.tojson())
    assert back.list_arguments() == sym.list_arguments()
    assert back.list_outputs() == sym.list_outputs()

    def attrs(s):
        return {n["name"]: n.get("attrs", {})
                for n in json.loads(s.tojson())["nodes"]
                if n["op"] in ("_contrib_MultiBoxPrior", "MultiBoxPrior",
                               "MultiBoxTarget", "MultiBoxDetection")}

    mine, theirs = attrs(sym), attrs(back)
    assert mine.keys() == theirs.keys() and len(mine) == 5
    for name, kv in mine.items():
        for key in ("sizes", "ratios", "steps", "variances"):
            if key in kv:
                assert eval(kv[key]) == eval(theirs[name][key]), (name, key)
    ex, _, _ = _bound(sym)
    ex2, _, _ = _bound(back)
    for a, b in zip(ex.forward(is_train=False), ex2.forward(is_train=False)):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def _plain_loss(cls_preds, loc_preds, loc_target, loc_mask, cls_target):
    """The SSD loss in plain torch: SoftmaxOutput(multi_output, use_ignore,
    normalization="valid") as a cross-entropy over the valid targets'
    count, and MakeLoss(normalization="valid") of the smooth-L1 terms over
    the count of its nonzero terms."""
    valid = cls_target >= 0
    logp = torch.log_softmax(cls_preds, dim=1)
    ce = -logp.gather(1, cls_target.clamp_min(0).long()[:, None])[:, 0]
    l_cls = (ce * valid).sum() / valid.sum().clamp_min(1)
    d = loc_mask * (loc_preds - loc_target)
    sl1 = torch.where(d.abs() < 1, 0.5 * d * d, d.abs() - 0.5)
    l_loc = sl1.sum() / (sl1 > 0).sum().clamp_min(1)
    return l_cls + l_loc


def test_c17_gradients_match_the_plain_torch_loss():
    """The port's MakeLoss and SoftmaxOutput backward (MXNet 1.x's) give
    every parameter the gradient of the plain SSD loss; the JAX
    ``MakeLoss`` is the identity (fault C17), so its executor's gradients
    differ."""
    sym = _train_symbol()
    ex, _, params = _bound(sym)
    ex.forward(is_train=True)
    ex.backward()
    got = {n: ex.grad_dict[n].asnumpy() for n in params}
    inner = sym.get_internals()
    parts = mx.sym.Group([inner["multibox_cls_pred_output"],
                          inner["multibox_loc_pred_output"],
                          inner["multibox_target_output0"],
                          inner["multibox_target_output1"],
                          inner["multibox_target_output2"]])
    x, y = _batch()
    leaves = {n: torch.tensor(v, requires_grad=True)
              for n, v in params.items()}
    outs = parts._build_eval()(dict(leaves, data=torch.tensor(x),
                                    label=torch.tensor(y)), {},
                               training=True)
    loss = _plain_loss(*outs)
    want = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    for n in params:
        np.testing.assert_allclose(got[n], want[n].numpy(), **GRAD,
                                   err_msg=n)
    assert max(np.abs(g).max() for g in got.values()) > 0
    # the JAX executor over the same graph: its identity MakeLoss passes
    # the head gradient of ones, so the location head's gradient differs
    jsym = jmx.sym.load_json(sym.tojson())
    shapes = _shapes()
    jex = jsym.simple_bind(jmx.cpu(), grad_req="write", **shapes)
    for n, v in dict(params, data=x, label=y).items():
        jex.arg_dict[n]._rebind(jmx.nd.array(v)._data)
    jex.forward(is_train=True)
    jex.backward()
    name = "body1_relu_loc_pred_conv_weight"
    assert not np.allclose(jex.grad_dict[name].asnumpy(), got[name],
                           rtol=1e-3, atol=1e-6)


def test_module_fit_lowers_the_loss_of_its_batch():
    """``train_net.py``'s ``Module.fit`` wiring over one batch repeated
    twice: the metric's two values are finite, the second forward's loss
    (after the first update) is lower, and the detections are valid."""
    cfg = dict(CFG, epoch_size=2, lr=0.01, mom=0.9, wd=5e-4,
               lr_step_epochs="80, 160", lr_factor=0.1, num_examples=16551)
    sym = _train_symbol()
    with mx.cpu():
        it = cs.SSDDataIter(cfg)
        mod = mx.mod.Module(sym, label_names=("label",), context=mx.cpu())
        losses, metric = [], cs.MultiBoxMetric()

        def probe(param):
            losses.append(cs.ssd_loss(mod.get_outputs()))

        mx.random.seed(0)
        mod.fit(it, eval_metric=metric, batch_end_callback=[probe],
                kvstore=mx.kv.create("local"), optimizer="sgd",
                optimizer_params={"learning_rate": cfg["lr"],
                                  "momentum": cfg["mom"], "wd": cfg["wd"],
                                  "lr_scheduler": cs._lr_scheduler(cfg)[1],
                                  "rescale_grad": 1.0},
                initializer=mx.init.Xavier(), num_epoch=1,
                allow_missing=True)
    names, values = metric.get_global()
    assert names == ["CrossEntropy", "SmoothL1"]
    assert all(np.isfinite(v) for v in values)
    assert len(losses) == 2 and losses[1] < losses[0]
    assert mod._optimizer.rescale_grad == 1.0
    ok, kept = cs.valid_detections(mod.get_outputs()[3])
    assert ok and min(kept) > 0


@pytest.mark.parametrize("reset", ["reset", "reset_local"])
def test_multibox_metric_keeps_two_values(reset):
    """The example's metric: two running values, folded into the epoch's
    by ``reset_local`` (Speedometer's auto-reset)."""
    metric = cs.MultiBoxMetric()
    prob = np.full((1, 3, 4), 1 / 3, np.float32)
    preds = [mx.nd.array(prob, ctx=mx.cpu()),
             mx.nd.array(np.ones((1, 16), np.float32), ctx=mx.cpu()),
             mx.nd.array(np.array([[0, 1, -1, 2]], np.float32),
                         ctx=mx.cpu())]
    metric.update(None, preds)
    np.testing.assert_allclose(metric.get()[1], [np.log(3), 16 / 3],
                               rtol=1e-5)
    getattr(metric, reset)()
    assert np.isnan(metric.get()[1]).all()
    glob = metric.get_global()[1]
    if reset == "reset":
        assert np.isnan(glob).all()
    else:
        np.testing.assert_allclose(glob, [np.log(3), 16 / 3], rtol=1e-5)
