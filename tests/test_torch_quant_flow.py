"""The port's post-training int8 flow against the JAX package's, on the
CPU, on a small exportable classifier (chip_smoke.build_classifier with
``gluon.nn.Embedding``: 2 layers, units 64, 4 heads, seq 16, vocab 128)
built in both packages from the same numpy weights:

* calibration: naive ranges to 1e-5 relative, entropy thresholds to one
  histogram bin, the quantized graph's census and the int8 weights equal;
* the slice as a whole: the JAX package's quantized checkpoint carried
  into the port (``convert``) and served by ``ModelServer`` through
  ``ServedModel.from_checkpoint`` / ``from_symbol``, against JAX
  ``qsym.eval_with``;
* ``model_info()`` / ``stats()`` report the int8 weights, and the
  port's ``quantize_net`` stays near its own float32 forward."""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import build_classifier, make_task, random_params
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu_torch import convert, serving
from mxnet_tpu_torch.contrib import quantization as q
from mxnet_tpu_torch.convert import load_jax_params

SMALL = {"vocab": 128, "units": 64, "hidden": 128, "heads": 4, "layers": 2,
         "seq_len": 16, "num_classes": 2}
CPU = mx.cpu()
N_FC = 6 * SMALL["layers"] + 2
# naive ranges are min and max of the same activations computed by two
# frameworks (float32, different summation orders)
RANGE_RTOL = 1e-5
# int8 logits, port vs JAX: most rows are bit for bit the same, but a
# float difference of 1e-7 between the two frameworks can flip an
# activation code at a rounding boundary, and the layers after it carry
# the flip on (measured: 33 of 34 rows equal, the other 3.1% of the
# largest logit away); so at least 90% of the rows must be equal, every
# row must pick the same class, and no logit may move by more than the
# quantization's own budget, 5% of the largest logit
EQUAL_ROWS = 0.9
LOGIT_SHARE = 0.05
# int8 vs float32 logits of one model: the JAX package's own bound
INT8_VS_F32 = 0.05


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Both packages' classifiers exported under fresh name managers (so
    node and parameter names agree) and their float checkpoints."""
    d = tmp_path_factory.mktemp("quant")
    weights = random_params(SMALL, seed=0)
    x, _ = make_task(64, SMALL["seq_len"], SMALL["vocab"], 2, seed=1)
    with mx.cpu():
        clf = build_classifier(mx, SMALL, exportable=True, prefix="clf_")
        clf.initialize(mx.init.Zero())
        load_jax_params(clf, weights)
        with mx.name.NameManager():
            clf.export(str(d / "port"))
    jclf = build_classifier(jmx, SMALL, exportable=True, prefix="clf_")
    jclf.initialize(jmx.init.Xavier())
    jclf(jmx.nd.array(x[:2]))
    for name, p in jclf._collect_params_with_structure().items():
        p.set_data(jmx.nd.array(weights[name]))
    with jmx.name.NameManager():
        jclf.export(str(d / "jax"))
    return {"dir": d, "x": x, "clf": clf, "jclf": jclf}


def _quantize_both(pair, mode):
    x = pair["x"]
    jsym, jargs, jauxs = jmx.model.load_checkpoint(str(pair["dir"] / "jax"), 0)
    jout = jq.quantize_model(
        jsym, jargs, jauxs, calib_mode=mode,
        calib_data=jmx.io.NDArrayIter(x, batch_size=32, label_name=None))
    jcal = jq.last_calibration()
    with mx.cpu():
        sym, args, auxs = mx.model.load_checkpoint(str(pair["dir"] / "port"),
                                                   0)
        out = q.quantize_model(
            sym, args, auxs, calib_mode=mode,
            calib_data=mx.io.NDArrayIter(x, batch_size=32, label_name=None))
    return out, jout, q.last_calibration(), jcal


def _calib_attrs(sym):
    return {n["name"]: (float(n["attrs"]["min_calib_range"]),
                        float(n["attrs"]["max_calib_range"]))
            for n in json.loads(sym.tojson())["nodes"]
            if n["op"] == "_contrib_quantized_fully_connected"}


def _census(sym):
    nodes = json.loads(sym.tojson())["nodes"]
    return sorted((n["op"], n["name"], len(n["inputs"])) for n in nodes)


def test_naive_calibration_census_and_int8_weights_match_jax(pair):
    (qsym, qargs, _), (jqsym, jqargs, _), cal, jcal = _quantize_both(
        pair, "naive")
    assert _census(qsym) == _census(jqsym)
    assert q.last_quantization()["ops"] == {
        "_contrib_quantized_fully_connected": N_FC,
        "_contrib_quantized_embedding": 1}
    got, want = _calib_attrs(qsym), _calib_attrs(jqsym)
    assert set(got) == set(want) and len(got) == N_FC
    for name, (lo, hi) in want.items():
        np.testing.assert_allclose(got[name], (lo, hi), rtol=RANGE_RTOL)
    assert cal["examples"] == jcal["examples"] == 64
    assert cal["batches"] == jcal["batches"] == 2
    assert set(qargs) == set(jqargs)
    for name, value in jqargs.items():
        mine = qargs[name].asnumpy()
        assert mine.dtype == value.asnumpy().dtype, name
        np.testing.assert_array_equal(mine, value.asnumpy(), err_msg=name)


def test_entropy_thresholds_match_jax_to_one_bin(pair):
    (qsym, _, _), (jqsym, _, _), cal, jcal = _quantize_both(pair, "entropy")
    assert set(cal["tensors"]) == set(jcal["tensors"])
    for name, t in jcal["tensors"].items():
        mine = cal["tensors"][name]
        # bins of the grown histogram are 2 * range / bins wide, the range
        # below max|x| + one bin
        width = 2 * max(abs(t["min_seen"]), abs(t["max_seen"])) / (
            t["bins"] - 2)
        assert abs(mine["threshold"] - t["threshold"]) <= width + 1e-6, name
        assert mine["bins"] == t["bins"], name
    assert set(_calib_attrs(qsym)) == set(_calib_attrs(jqsym))


def _requests(n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, SMALL["vocab"], (rs.randint(1, 5),
                                           SMALL["seq_len"]))
            .astype(np.float32) for _ in range(n)]


def test_jax_int8_checkpoint_serves_in_the_port(pair, tmp_path):
    """The JAX package quantizes and saves; the port loads the pair
    (``convert.load_jax_checkpoint`` and ``from_checkpoint``, and the
    in-memory dicts through ``convert.load_jax_model``) and serves it;
    every answer is held against JAX ``qsym.eval_with``. Measured: 33 of
    the 34 rows bit for bit equal, the other one 0.045 away (3.1% of its
    request's largest logit), the same class everywhere."""
    x = pair["x"]
    jsym, jargs, jauxs = jmx.model.load_checkpoint(str(pair["dir"] / "jax"), 0)
    jqsym, jqargs, jqauxs = jq.quantize_model(
        jsym, jargs, jauxs, calib_mode="naive",
        calib_data=jmx.io.NDArrayIter(x, batch_size=32, label_name=None))
    prefix = str(tmp_path / "jq")
    jmx.model.save_checkpoint(prefix, 0, jqsym, jqargs, jqauxs)

    sym, args, auxs = convert.load_jax_checkpoint(prefix, 0, ctx=CPU)
    assert {k: v.dtype for k, v in args.items()
            if k.endswith("_quantize")} == {
        k: torch.int8 for k in jqargs if k.endswith("_quantize")}
    sym2, args2, _ = convert.load_jax_model(
        jqsym.tojson(), {k: v.asnumpy() for k, v in jqargs.items()}, ctx=CPU)
    assert sym2.list_arguments() == sym.list_arguments()
    with pytest.raises(mx.MXNetError, match="not inputs"):
        convert.load_jax_model(jqsym.tojson(), {"nope": np.zeros(1)},
                               ctx=CPU)

    container = serving.ModelContainer()
    container.add_checkpoint("ckpt", prefix, 0,
                             example_shape=(SMALL["seq_len"],), ctx=CPU)
    container.add_symbol("dicts", sym2, args2,
                         example_shape=(SMALL["seq_len"],), ctx=CPU)
    server = serving.ModelServer(container, max_wait_ms=2.0).start()
    try:
        server.warmup()
        reqs = _requests(12, seed=5)
        futs = [(server.submit("ckpt", r), server.submit("dicts", r))
                for r in reqs]
        rows = equal = 0
        for r, (fa, fb) in zip(reqs, futs):
            want = jqsym.eval_with({"data": jmx.nd.array(r), **jqargs}) \
                .asnumpy()
            for got in (fa.result(timeout=60), fb.result(timeout=60)):
                assert got.shape == want.shape
                np.testing.assert_array_equal(got.argmax(-1),
                                              want.argmax(-1))
                assert np.abs(got - want).max() <= \
                    LOGIT_SHARE * np.abs(want).max()
                rows += got.shape[0]
                equal += int((got == want).all(axis=1).sum())
        assert equal >= EQUAL_ROWS * rows, f"{equal} of {rows} rows equal"
        stats = server.stats()["models"]
        assert stats["ckpt"]["completed"] == stats["dicts"]["completed"] == 12
    finally:
        assert server.drain(timeout=30)


def test_served_int8_model_reports_weight_dtype(pair):
    """As tests/test_quantization.py:364-402: the quantized pair loads
    through the standard loaders, is detected as int8 in ``model_info``
    and ``stats()``, and predicts what direct graph evaluation gives."""
    x = pair["x"]
    with mx.cpu():
        sym, args, auxs = mx.model.load_checkpoint(str(pair["dir"] / "port"),
                                                   0)
        qsym, qargs, _ = q.quantize_model(
            sym, args, auxs, calib_mode="entropy",
            calib_data=mx.io.NDArrayIter(x, batch_size=16, label_name=None))
    container = serving.ModelContainer()
    qmodel = container.add_symbol("qmodel", qsym, qargs, ctx=CPU,
                                  example_shape=(SMALL["seq_len"],),
                                  buckets=(2, 4))
    fmodel = container.add_symbol("fmodel", sym, args, ctx=CPU,
                                  example_shape=(SMALL["seq_len"],),
                                  buckets=(2, 4))
    assert qmodel.weight_dtype == "int8" and qmodel.quantized
    assert fmodel.weight_dtype == "float32" and not fmodel.quantized
    server = serving.ModelServer(container, max_wait_ms=1.0).start()
    try:
        server.warmup()
        info = server.model_info()
        assert info["qmodel"]["weight_dtype"] == "int8"
        assert info["qmodel"]["quantized"] is True
        assert info["fmodel"]["weight_dtype"] == "float32"
        got = server.predict("qmodel", x[:2], timeout=30.0)
        want = qsym.eval_with({"data": mx.nd.array(x[:2], ctx=CPU)},
                              qargs).asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        stats = server.stats()["models"]["qmodel"]
        assert stats["weight_dtype"] == "int8"
        assert stats["dtype"] == "float32"
    finally:
        assert server.drain(timeout=10.0)


def test_quantize_net_stays_near_the_float_forward(pair):
    """``quantize_net`` on the port's block (export, calibrate, quantize,
    save, ``SymbolBlock.imports``), all on the CPU: int8 weights, and
    logits within the JAX tests' 5% of the float32 forward."""
    clf, x = pair["clf"], pair["x"]
    with mx.cpu():
        qnet = q.quantize_net(clf, mx.nd.array(x), ctx=CPU)
        out = qnet(mx.nd.array(x)).asnumpy()
        ref = clf(mx.nd.array(x)).asnumpy()
    dtypes = {p.data().dtype for p in qnet.collect_params().values()}
    assert torch.int8 in dtypes
    assert np.abs(out - ref).max() / np.abs(ref).max() < INT8_VS_F32
    census = json.loads(qnet.symbol.tojson())["nodes"]
    assert sum(n["op"] == "_contrib_quantized_fully_connected"
               for n in census) == N_FC
