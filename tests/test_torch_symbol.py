"""The port's symbol graph (mxnet_tpu_torch/symbol) against the JAX
package's on the CPU: composing ops by hand gives the same nodes, the
same auto-created parameter variables and the same JSON; the graph
lists, internals and shape inference agree on a traced encoder; the
evaluator frees nothing a later node needs."""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import build_classifier, random_params
from mxnet_tpu_torch.convert import load_jax_params

SMALL = {"vocab": 50, "units": 32, "hidden": 64, "heads": 4, "layers": 1,
         "seq_len": 8, "num_classes": 3}
RTOL = ATOL = 1e-5  # float32, a few ops, two frameworks on the CPU


def _mlp(sym):
    data = sym.var("data")
    fc1 = sym.FullyConnected(data, num_hidden=6, name="fc1")
    act = sym.Activation(fc1, act_type="tanh", name="act")
    fc2 = sym.FullyConnected(act, num_hidden=2, no_bias=True,
                             flatten=False, name="fc2")
    return sym.elemwise_add(fc2, fc2, name="twice")


def _nodes(s):
    return [(n["op"], n["name"], n["inputs"], n.get("attrs"))
            for n in json.loads(s.tojson())["nodes"]]


def test_composed_graph_is_the_jax_graph():
    port, jax = _mlp(mx.sym), _mlp(jmx.sym)
    assert port.list_arguments() == jax.list_arguments() == [
        "data", "fc1_weight", "fc1_bias", "fc2_weight"]
    assert port.list_outputs() == jax.list_outputs() == ["twice_output"]
    assert _nodes(port) == _nodes(jax)
    assert port.get_internals().list_outputs() == \
        jax.get_internals().list_outputs()
    rs = np.random.RandomState(0)
    vals = {"data": rs.randn(3, 5), "fc1_weight": rs.randn(6, 5),
            "fc1_bias": rs.randn(6), "fc2_weight": rs.randn(2, 6)}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    got = port.eval_with({k: mx.nd.array(v, ctx=mx.cpu())
                          for k, v in vals.items()}).asnumpy()
    want = jax.eval_with({k: jmx.nd.array(v)
                          for k, v in vals.items()}).asnumpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    args, outs, auxs = port.infer_shape(data=(3, 5))
    assert (args, outs, auxs) == tuple(
        [tuple(s) for s in x] for x in jax.infer_shape(data=(3, 5)))
    assert port["twice_output"].name == "twice"
    with pytest.raises(mx.MXNetError, match="missing inputs"):
        port.eval_with({"data": mx.nd.array(vals["data"], ctx=mx.cpu())})
    with pytest.raises(mx.MXNetError, match="not ported"):
        mx.sym.load_json(json.dumps({"nodes": [
            {"op": "Deconvolution", "name": "c", "inputs": []}]}))


def test_traced_encoder_lists_and_shapes_match_jax():
    weights = random_params(SMALL, seed=1)
    with mx.cpu():
        clf = build_classifier(mx, SMALL, exportable=True, prefix="c_")
        clf.initialize(mx.init.Zero())
        load_jax_params(clf, weights)
        with mx.name.NameManager():
            port = clf._trace_symbol()
    jclf = build_classifier(jmx, SMALL, exportable=True, prefix="c_")
    jclf.initialize(jmx.init.Xavier())
    jclf(jmx.nd.zeros((1, SMALL["seq_len"])))  # resolve deferred shapes
    with jmx.name.NameManager():
        jax = jclf._trace_symbol()
    assert port.list_arguments() == jax.list_arguments()
    assert port.get_internals().list_outputs() == \
        jax.get_internals().list_outputs()
    shapes = {"data": (2, SMALL["seq_len"])}
    got, want = port.infer_shape(**shapes), jax.infer_shape(**shapes)
    for a, b in zip(got, want):
        assert a == [tuple(s) for s in b]
    # every intermediate of one forward, through the graph evaluator
    x = np.random.RandomState(2).randint(0, SMALL["vocab"], (2, 8)).astype(
        np.float32)
    params = {n: p.data() for n, p in clf.collect_params().items()}
    with mx.cpu():
        outs = port.get_internals().eval_with(
            {"data": mx.nd.array(x)}, params)
        final = clf(mx.nd.array(x)).asnumpy()
    assert len(outs) == len(port.get_internals().list_outputs())
    np.testing.assert_array_equal(outs[-1].asnumpy(), final)
