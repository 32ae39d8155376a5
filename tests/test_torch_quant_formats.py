"""File formats shared by the port and the JAX package, on the CPU:
``.params`` files (``nd.save`` / ``nd.load``: int8, float32, bfloat16,
lists and dicts) and symbol JSON (a traced classifier and a quantized
graph with its calibration attributes) load both ways; ``export`` ->
``load_checkpoint`` -> ``SymbolBlock.imports`` reproduces a block's
forward in the port."""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import build_classifier, make_task, random_params
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu_torch.convert import load_jax_params

SMALL = {"vocab": 128, "units": 64, "hidden": 128, "heads": 4, "layers": 2,
         "seq_len": 16, "num_classes": 2}
CPU = mx.cpu()
# float32 logits through two encoder layers, two frameworks on the CPU
RTOL = ATOL = 1e-4


def _arrays(seed):
    rs = np.random.RandomState(seed)
    return {"w8": rs.randint(-127, 128, (5, 7)).astype(np.int8),
            "f32": rs.randn(3, 4).astype(np.float32),
            "i32": rs.randint(0, 99, (6,)).astype(np.int32),
            "bf16": rs.randn(2, 3).astype(np.float32)}


def test_params_files_load_both_ways(tmp_path):
    a = _arrays(0)
    port = {k: mx.nd.array(v, ctx=CPU, dtype="bfloat16" if k == "bf16"
                           else None) for k, v in a.items()}
    mx.nd.save(str(tmp_path / "port.params"), port)
    got = jmx.nd.load(str(tmp_path / "port.params"))
    assert set(got) == set(a)
    for k, v in a.items():
        want = port[k]._data.float().numpy() if k == "bf16" else v
        assert np.dtype(got[k].dtype).name == ("bfloat16" if k == "bf16"
                                               else v.dtype.name)
        np.testing.assert_array_equal(np.asarray(got[k].asnumpy(),
                                                 np.float32 if k == "bf16"
                                                 else v.dtype), want)

    jmx.nd.save(str(tmp_path / "jax.params"),
                {k: jmx.nd.array(v, dtype="bfloat16" if k == "bf16"
                                 else v.dtype) for k, v in a.items()})
    back = mx.nd.load(str(tmp_path / "jax.params"), ctx=CPU)
    assert back["w8"].dtype == torch.int8
    assert back["bf16"].dtype == torch.bfloat16
    for k, v in a.items():
        if k == "bf16":
            assert torch.equal(back[k]._data, port[k]._data)
        else:
            np.testing.assert_array_equal(back[k].asnumpy(), v)

    mx.nd.save(str(tmp_path / "list.params"),
               [mx.nd.array(a["w8"], ctx=CPU), mx.nd.array(a["f32"], ctx=CPU)])
    listed = jmx.nd.load(str(tmp_path / "list.params"))
    np.testing.assert_array_equal(listed[0].asnumpy(), a["w8"])
    with mx.cpu():
        again = mx.nd.load(str(tmp_path / "list.params"))
    np.testing.assert_array_equal(again[1].asnumpy(), a["f32"])


@pytest.fixture(scope="module")
def classifiers():
    """The small exportable classifier in both packages, same weights,
    parameters named ``clf_...`` in both."""
    weights = random_params(SMALL, seed=0)
    with mx.cpu():
        clf = build_classifier(mx, SMALL, exportable=True, prefix="clf_")
        clf.initialize(mx.init.Zero())
        load_jax_params(clf, weights)
    jclf = build_classifier(jmx, SMALL, exportable=True, prefix="clf_")
    jclf.initialize(jmx.init.Xavier())
    x, _ = make_task(8, SMALL["seq_len"], SMALL["vocab"], 2, seed=3)
    jclf(jmx.nd.array(x))
    for name, p in jclf._collect_params_with_structure().items():
        p.set_data(jmx.nd.array(weights[name]))
    return clf, jclf, x


def test_traced_graphs_load_both_ways(classifiers, tmp_path):
    clf, jclf, x = classifiers
    want = jclf(jmx.nd.array(x)).asnumpy()
    with mx.name.NameManager():
        clf.export(str(tmp_path / "port"))
    with jmx.name.NameManager():
        jclf.export(str(tmp_path / "jax"))
    port_json = json.loads((tmp_path / "port-symbol.json").read_text())
    jax_json = json.loads((tmp_path / "jax-symbol.json").read_text())
    assert [(n["op"], n["name"], n["inputs"]) for n in port_json["nodes"]] \
        == [(n["op"], n["name"], n["inputs"]) for n in jax_json["nodes"]]

    # the port's pair in the JAX package, and the JAX pair in the port
    sym, args, auxs = jmx.model.load_checkpoint(str(tmp_path / "port"), 0)
    got = sym.eval_with({"data": jmx.nd.array(x), **args, **auxs}).asnumpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    sym, args, auxs = mx.model.load_checkpoint(str(tmp_path / "jax"), 0,
                                               ctx=CPU)
    got = sym.eval_with({"data": mx.nd.array(x, ctx=CPU)},
                        dict(args, **auxs)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert sym.infer_shape(data=(3, SMALL["seq_len"]))[1] == [(3, 2)]


def test_export_imports_reproduces_the_block(classifiers, tmp_path):
    """``export`` -> ``load_checkpoint`` -> ``SymbolBlock.imports`` in the
    port: the same forward to 1e-6 (the same ops on the same values)."""
    clf, _, x = classifiers
    prefix = str(tmp_path / "net")
    sym = clf.export(prefix)
    assert len(sym.list_outputs()) == 1
    with mx.cpu():
        want = clf(mx.nd.array(x)).asnumpy()
        block = mx.gluon.SymbolBlock.imports(f"{prefix}-symbol.json",
                                             ["data"],
                                             f"{prefix}-0000.params")
        got = block(mx.nd.array(x)).asnumpy()
        _, args, _ = mx.model.load_checkpoint(prefix, 0)
        # a block whose parameters wait for the first forward's shapes
        lazy = mx.gluon.SymbolBlock(mx.sym.load(f"{prefix}-symbol.json"),
                                    ["data"])
        lazy.collect_params().initialize(mx.init.Zero())
        lazy(mx.nd.array(x))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert set(args) == set(block.collect_params().keys())
    for name, p in lazy.collect_params().items():
        assert p.data().shape == args[name].shape, name


def test_quantized_graph_json_loads_both_ways(classifiers):
    """A JAX ``quantize_model`` graph through the port's JSON and back:
    every node, input and attribute the same, the calibration floats
    exactly."""
    _, jclf, x = classifiers
    with jmx.name.NameManager():
        sym = jclf._trace_symbol()
    args = {n: p.data() for n, p in jclf.collect_params().items()}
    it = jmx.io.NDArrayIter(x, batch_size=4, label_name=None)
    qsym, _, _ = jq.quantize_model(sym, args, {}, calib_data=it,
                                   calib_mode="naive")
    text = qsym.tojson()
    port = mx.sym.load_json(text)
    back = jmx.sym.load_json(port.tojson())

    def nodes(s):
        return [(n["op"], n["name"], n["inputs"], n.get("attrs"))
                for n in json.loads(s.tojson())["nodes"]]

    assert nodes(back) == nodes(qsym)
    floats = [(n["name"], n["attrs"]["min_calib_range"])
              for n in json.loads(port.tojson())["nodes"]
              if n["op"] == "_contrib_quantized_fully_connected"]
    assert len(floats) == 6 * SMALL["layers"] + 2
    orig = {n["name"]: n["attrs"]["min_calib_range"]
            for n in json.loads(text)["nodes"] if "attrs" in n
            and "min_calib_range" in n["attrs"]}
    for name, value in floats:
        assert float(value) == float(orig[name])
