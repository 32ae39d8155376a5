"""The post-training int8 flow over convolutional networks, the port's
(``contrib/quantization.py`` with ``_contrib_quantized_conv``) against
the JAX package's on the CPU, from the same float32 parameters and
calibration batches: ``examples/quantization/quantize_mnist.py``'s CNN
and a thumbnail resnet18_v1 (10 classes, 32x32) exported by both
packages under fresh name managers.

Tolerances:
* naive ranges: ``RANGE_RTOL`` relative (min and max of the same
  activations computed by two frameworks in different summation
  orders); the int8 weights and float32 scales bit for bit;
* entropy thresholds: one bin of the grown histogram;
* the int8 forward: each product is exact in both packages, but the
  float32 convolutions of calibration and the float32 BatchNorm between
  the int8 layers round differently in the last bit, which can move an
  activation code across a rounding boundary, and later layers carry
  the flip on; every row picks the same class and no logit moves by
  more than ``LOGIT_SHARE`` of the largest (the ROADMAP Caveats' 5%)."""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import mnist_sym
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu_torch.contrib import quantization as q
from mxnet_tpu_torch.convert import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo import vision

CPU = mx.cpu()
RANGE_RTOL = 1e-5
LOGIT_SHARE = 0.05


def _mnist_params(seed=0):
    rs = np.random.RandomState(seed)
    shapes = {"conv1_weight": (8, 1, 3, 3), "conv1_bias": (8,),
              "fc1_weight": (64, 1352), "fc1_bias": (64,),
              "fc2_weight": (10, 64), "fc2_bias": (10,)}
    out = {}
    for k, s in shapes.items():
        fan = int(np.prod(s[1:])) if len(s) > 1 else 10
        out[k] = (rs.randn(*s) * (1.0 / np.sqrt(fan))).astype(np.float32)
    return out


def _both(m, sym, params, x, mode, **kw):
    """quantize_model over batches of 16 with labels, as the example
    calibrates on its training iterator."""
    y = np.arange(x.shape[0], dtype=np.float32) % 10
    if m is mx:
        args = {k: mx.nd.array(v, ctx=CPU) for k, v in params.items()}
        with mx.cpu():
            it = mx.io.NDArrayIter(x, y, batch_size=16)
            out = q.quantize_model(sym, args, {}, calib_mode=mode,
                                   calib_data=it, **kw)
        return out, q.last_calibration(), q.last_quantization()
    args = {k: jmx.nd.array(v) for k, v in params.items()}
    it = jmx.io.NDArrayIter(x, y, batch_size=16)
    out = jq.quantize_model(sym, args, {}, calib_mode=mode, calib_data=it,
                            **kw)
    return out, jq.last_calibration(), jq.last_quantization()


def _calib_attrs(qsym):
    return {n["name"]: (float(n["attrs"]["min_calib_range"]),
                        float(n["attrs"]["max_calib_range"]))
            for n in json.loads(qsym.tojson())["nodes"]
            if n["op"].startswith("_contrib_quantized_")}


def _census(qsym):
    return sorted((n["op"], n["name"], len(n["inputs"]))
                  for n in json.loads(qsym.tojson())["nodes"])


def _thresholds_within_a_bin(cal, jcal):
    assert set(cal["tensors"]) == set(jcal["tensors"])
    for name, t in jcal["tensors"].items():
        mine = cal["tensors"][name]
        width = 2 * max(abs(t["min_seen"]), abs(t["max_seen"])) / (
            t["bins"] - 2)
        assert abs(mine["threshold"] - t["threshold"]) <= width + 1e-6, name
        assert mine["bins"] == t["bins"], name


def _forward(m, qsym, qargs, qauxs, out_name, x):
    head = qsym.get_internals()[out_name]
    if m is mx:
        feed = {"data": mx.nd.array(x, ctx=CPU), **qargs, **qauxs}
        return head.eval_with(feed).asnumpy()
    return head.eval_with({"data": jmx.nd.array(x), **qargs,
                           **qauxs}).asnumpy()


def _logits_close(got, want):
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() <= LOGIT_SHARE * np.abs(want).max()


@pytest.mark.parametrize("granularity", ["channel-wise", "tensor-wise"])
def test_mnist_cnn_naive_matches_jax(granularity):
    params = _mnist_params()
    x = np.random.RandomState(1).rand(32, 1, 28, 28).astype(np.float32)
    with mx.name.NameManager():
        sym = mnist_sym(mx)
    with jmx.name.NameManager():
        jsym = mnist_sym(jmx)
    (qsym, qargs, qauxs), cal, qp = _both(
        mx, sym, params, x, "naive", quantize_granularity=granularity)
    (jqsym, jqargs, jqauxs), jcal, jqp = _both(
        jmx, jsym, params, x, "naive", quantize_granularity=granularity)
    assert _census(qsym) == _census(jqsym)
    assert qp["ops"] == jqp["ops"] == {"_contrib_quantized_conv": 1,
                                       "_contrib_quantized_fully_connected":
                                           2}
    got, want = _calib_attrs(qsym), _calib_attrs(jqsym)
    assert set(got) == set(want) == {"conv1", "fc1", "fc2"}
    for name, rng in want.items():
        np.testing.assert_allclose(got[name], rng, rtol=RANGE_RTOL)
    assert set(qargs) == set(jqargs)
    for name, v in jqargs.items():
        np.testing.assert_array_equal(qargs[name].asnumpy(), v.asnumpy(),
                                      err_msg=name)
    _logits_close(_forward(mx, qsym, qargs, qauxs, "fc2_output", x[:8]),
                  _forward(jmx, jqsym, jqargs, jqauxs, "fc2_output", x[:8]))


def test_mnist_cnn_entropy_and_exclusion_match_jax():
    params = _mnist_params(2)
    x = np.random.RandomState(3).rand(48, 1, 28, 28).astype(np.float32)
    with mx.name.NameManager():
        sym = mnist_sym(mx)
    with jmx.name.NameManager():
        jsym = mnist_sym(jmx)
    (qsym, _, _), cal, _ = _both(mx, sym, params, x, "entropy")
    (jqsym, _, _), jcal, _ = _both(jmx, jsym, params, x, "entropy")
    _thresholds_within_a_bin(cal, jcal)
    assert cal["examples"] == jcal["examples"] == 48
    (qsym, qargs, _), _, qp = _both(mx, sym, params, x, "naive",
                                    excluded_sym_names=["conv1"])
    (jqsym, _, _), _, jqp = _both(jmx, jsym, params, x, "naive",
                                  excluded_sym_names=["conv1"])
    assert _census(qsym) == _census(jqsym)
    assert qp["ops"] == jqp["ops"] == {
        "_contrib_quantized_fully_connected": 2}
    assert "conv1_weight" in qargs and "conv1_weight_quantize" not in qargs


@pytest.fixture
def fresh_names(monkeypatch):
    from mxnet_tpu_torch.gluon.block import _BlockScope

    monkeypatch.setattr(_BlockScope._tls, "top", {}, raising=False)
    with jmx.name.NameManager():
        yield


@pytest.fixture
def resnet_pair(tmp_path, fresh_names):
    x = np.random.RandomState(4).rand(16, 3, 32, 32).astype(np.float32)
    jnet = jvision.get_model("resnet18_v1", classes=10, thumbnail=True)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x[:1]))
    weights = {n: p.data().asnumpy()
               for n, p in jnet._collect_params_with_structure().items()}
    with jmx.name.NameManager():
        jnet.export(str(tmp_path / "jax"))
    with mx.cpu():
        net = vision.get_model("resnet18_v1", classes=10, thumbnail=True)
        net.initialize(mx.init.Zero())
        net(mx.nd.array(x[:1]))
        load_jax_params(net, weights)
        with mx.name.NameManager():
            net.export(str(tmp_path / "port"))
        sym, args, auxs = mx.model.load_checkpoint(str(tmp_path / "port"),
                                                   0)
    jsym, jargs, jauxs = jmx.model.load_checkpoint(str(tmp_path / "jax"), 0)
    return x, (sym, args, auxs), (jsym, jargs, jauxs)


def _resnet_quantize(pair, mode, **kw):
    x, (sym, args, auxs), (jsym, jargs, jauxs) = pair
    with mx.cpu():
        out = q.quantize_model(sym, args, auxs, calib_mode=mode,
                               calib_data=mx.io.NDArrayIter(
                                   x, batch_size=8, label_name=None),
                               label_names=(), **kw)
    jout = jq.quantize_model(jsym, jargs, jauxs, calib_mode=mode,
                             calib_data=jmx.io.NDArrayIter(
                                 x, batch_size=8, label_name=None),
                             label_names=(), **kw)
    return out, jout, q.last_calibration(), jq.last_calibration()


def test_thumbnail_resnet_naive_matches_jax(resnet_pair):
    x = resnet_pair[0]
    (qsym, qargs, qauxs), (jqsym, jqargs, jqauxs), cal, jcal = \
        _resnet_quantize(resnet_pair, "naive")
    assert _census(qsym) == _census(jqsym)
    census = q.last_quantization()["ops"]
    assert census == {"_contrib_quantized_conv": 20,
                      "_contrib_quantized_fully_connected": 1}
    got, want = _calib_attrs(qsym), _calib_attrs(jqsym)
    assert set(got) == set(want) and len(got) == 21
    for name, rng in want.items():
        np.testing.assert_allclose(got[name], rng, rtol=RANGE_RTOL,
                                   err_msg=name)
    assert set(qargs) == set(jqargs)
    for name, v in jqargs.items():
        np.testing.assert_array_equal(qargs[name].asnumpy(), v.asnumpy(),
                                      err_msg=name)
    out = qsym.list_outputs()[0]
    _logits_close(_forward(mx, qsym, qargs, qauxs, out, x[:4]),
                  _forward(jmx, jqsym, jqargs, jqauxs, out, x[:4]))


def test_thumbnail_resnet_entropy_thresholds_match_jax_to_one_bin(
        resnet_pair):
    (qsym, _, _), (jqsym, _, _), cal, jcal = _resnet_quantize(
        resnet_pair, "entropy")
    _thresholds_within_a_bin(cal, jcal)
    assert set(_calib_attrs(qsym)) == set(_calib_attrs(jqsym))


def test_int8_mnist_module_binds_scores_and_serves_on_the_cpu():
    """The int8 graph of the CNN through ``Module.bind`` (the quantized
    convolution's shape rules) and ``Module.score``, against the graph
    evaluated directly."""
    params = _mnist_params()
    rs = np.random.RandomState(5)
    x = rs.rand(32, 1, 28, 28).astype(np.float32)
    y = rs.randint(0, 10, 32).astype(np.float32)
    with mx.cpu():
        sym = mnist_sym(mx)
        args = {k: mx.nd.array(v) for k, v in params.items()}
        qsym, qargs, qauxs = q.quantize_model(
            sym, args, {}, calib_mode="naive",
            calib_data=mx.io.NDArrayIter(x, y, batch_size=16))
        it = mx.io.NDArrayIter(x, y, batch_size=16)
        mod = mx.mod.Module(qsym, context=CPU)
        mod.bind(it.provide_data, it.provide_label, for_training=False)
        mod.init_params(arg_params=qargs, aux_params=qauxs,
                        allow_missing=False)
        acc = dict(mod.score(it, "acc"))["accuracy"]
        probs = qsym.eval_with({"data": mx.nd.array(x),
                                "softmax_label": mx.nd.array(y),
                                **qargs}).asnumpy()
    assert acc == pytest.approx(float((probs.argmax(1) == y).mean()))


def test_quantize_net_over_a_gluon_cnn_with_an_excluded_conv():
    rs = np.random.RandomState(6)
    x = rs.rand(16, 3, 12, 12).astype(np.float32)
    with mx.cpu():
        nn = mx.gluon.nn
        net = nn.HybridSequential(prefix="cnn_")
        with net.name_scope():
            net.add(nn.Conv2D(8, 3, padding=1, activation="relu"),
                    nn.Conv2D(8, 3, strides=2, groups=2),
                    nn.BatchNorm(), nn.Activation("relu"),
                    nn.GlobalAvgPool2D(), nn.Dense(5))
        net.initialize(mx.init.Xavier())
        ref = net(mx.nd.array(x)).asnumpy()
        with mx.name.NameManager():   # nodes named from 0
            qnet = q.quantize_net(net, mx.nd.array(x), calib_mode="naive",
                                  excluded_layers=["convolution0"])
        got = qnet(mx.nd.array(x)).asnumpy()
    census = q.last_quantization()["ops"]
    assert census == {"_contrib_quantized_conv": 1,
                      "_contrib_quantized_fully_connected": 1}
    assert np.abs(got - ref).max() <= 0.1 * np.abs(ref).max()


@pytest.mark.parametrize("seed,n,kind", [(0, 200_000, "normal"),
                                         (1, 50_000, "cauchy"),
                                         (2, 20_000, "relu")])
@pytest.mark.parametrize("bins", [2048, 1000, 300])
def test_kl_search_equals_the_jax_packages_loop(seed, n, kind, bins):
    """The port's KL search projects each candidate onto the int8 levels
    in one ``np.add.reduceat``; the JAX package loops over the levels.
    The sums are of integer counts, so the thresholds and divergences are
    equal bit for bit, on grown histograms too."""
    rs = np.random.RandomState(seed)
    col = q._HistogramCollector(bins)
    for part in range(3):
        a = {"normal": rs.randn(n) * (1 + part),
             "cauchy": rs.standard_cauchy(n),
             "relu": np.maximum(rs.randn(n) + part, 0)}[kind]
        col.collect("t", a)
    hist, edges, *_ = col.state["t"]
    assert q.kl_optimal_threshold(hist, edges) == \
        jq.kl_optimal_threshold(hist, edges)
    assert q.kl_optimal_threshold(hist, edges, 127) == \
        jq.kl_optimal_threshold(hist, edges, 127)
