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
            {"op": "_npi_no_such_op", "name": "c", "inputs": []}]}))


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


# ------------------------------------------------- the tensor/math ops ----

def _new_ops_graph(sym):
    """A graph of this slice's ops: aliases, callable output counts
    (SliceChannel, split_v2), variadic inputs (Concat, add_n), ops with
    no gradient (argmax, topk) and the scalar family."""
    data, other = sym.var("data"), sym.var("other")
    a = sym.broadcast_add(data, other, name="badd")
    b = sym.clip(a, a_min=-0.5, a_max=0.75, name="clip")
    c = sym._mul_scalar(b, scalar=2.0, name="twice")
    parts = sym.SliceChannel(c, num_outputs=2, axis=1, name="halves")
    d = sym.Concat(parts[1], parts[0], sym.tanh(c, name="t"), dim=1,
                   name="cat")
    e = sym.sum(d, axis=1, keepdims=True, name="s")
    f = sym.topk(d, k=2, ret_typ="value", name="top")
    g = sym.expand_dims(sym.argmax(d, axis=1, name="am"), axis=1,
                        name="ed")
    h = sym.split_v2(d, indices=(1, 3), axis=1, name="sp")
    i = sym.add_n(h[0], sym._greater_scalar(h[0], scalar=0.0, name="gt"),
                  name="an")
    j = sym.Cast(sym.one_hot(sym.argmax(other, axis=1, name="am2"),
                             depth=5, name="oh"), dtype="int32", name="c32")
    k = sym.SequenceMask(sym.swapaxes(d, dim1=0, dim2=1, name="sw"),
                         name="sm")
    return sym.Group([e, f, g, i, h[2], j, k])


def _feeds():
    rs = np.random.RandomState(3)
    return {"data": rs.randn(3, 4).astype(np.float32),
            "other": rs.randn(1, 4).astype(np.float32)}


def _eval_port(s, feeds):
    out = s.eval_with({k: mx.nd.array(v, ctx=mx.cpu())
                       for k, v in feeds.items()})
    return [o.asnumpy() for o in (out if isinstance(out, list) else [out])]


def _eval_jax(s, feeds):
    out = s.eval_with({k: jmx.nd.array(v) for k, v in feeds.items()})
    return [o.asnumpy() for o in (out if isinstance(out, list) else [out])]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=RTOL,
                                   atol=ATOL)


def test_a_jax_graph_of_the_new_ops_loads_and_evaluates_in_the_port():
    jsym = _new_ops_graph(jmx.sym)
    psym = mx.sym.load_json(jsym.tojson())
    assert psym.list_outputs() == jsym.list_outputs()
    assert psym.list_arguments() == jsym.list_arguments()
    feeds = _feeds()
    _same(_eval_port(psym, feeds), _eval_jax(jsym, feeds))
    _, outs, _ = psym.infer_shape(data=(3, 4), other=(1, 4))
    assert outs == [tuple(s) for s in jsym.infer_shape(
        data=(3, 4), other=(1, 4))[1]]
    _, types, _ = psym.infer_type(data="float32", other="float32")
    assert [str(t).replace("torch.", "") for t in types] == [
        np.dtype(t).name for t in jsym.infer_type(data="float32",
                                                  other="float32")[1]]


def test_the_ports_graph_of_the_new_ops_loads_and_evaluates_in_jax():
    psym = _new_ops_graph(mx.sym)
    jsym = jmx.sym.load_json(psym.tojson())
    assert jsym.list_outputs() == psym.list_outputs()
    assert _nodes(psym) == _nodes(_new_ops_graph(jmx.sym))
    feeds = _feeds()
    _same(_eval_jax(jsym, feeds), _eval_port(psym, feeds))


def test_mxnet_style_string_attributes_are_parsed_as_the_schema_does():
    """Attributes as MXNet writes them: numbers, tuples, booleans and
    None as strings, an int where the default is a float."""
    graph = {"nodes": [
        {"op": "null", "name": "x", "inputs": []},
        {"op": "SliceChannel", "name": "sc", "inputs": [[0, 0, 0]],
         "attrs": {"num_outputs": "2", "axis": "1",
                   "squeeze_axis": "False"}},
        {"op": "_plus_scalar", "name": "p", "inputs": [[1, 1, 0]],
         "attrs": {"scalar": "2"}},
        {"op": "clip", "name": "c", "inputs": [[2, 0, 0]],
         "attrs": {"a_min": "None", "a_max": "2.5"}},
        {"op": "slice", "name": "sl", "inputs": [[3, 0, 0]],
         "attrs": {"begin": "(0, None)", "end": "[2, None]",
                   "step": "(1, -1)"}},
        {"op": "sort", "name": "so", "inputs": [[4, 0, 0]],
         "attrs": {"is_ascend": "false"}}],
        "arg_nodes": [0], "heads": [[5, 0, 0], [1, 0, 0]]}
    s = mx.sym.load_json(json.dumps(graph))
    node = s._entries[0][0]
    assert node.attrs == {"is_ascend": False}
    assert node.inputs[0][0].attrs["end"] == (2, None)
    sc = s._entries[1][0]
    assert sc.num_outputs == 2 and sc.attrs["squeeze_axis"] is False
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    got, first = _eval_port(s, {"x": x})
    want = np.sort(np.clip(x[:, 2:] + 2.0, None, 2.5)[0:2, ::-1],
                   axis=-1)[:, ::-1]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(first, x[:, :2])


class _UsesNewOps(mx.gluon.HybridBlock):
    """``F.<op>`` inside ``hybrid_forward``: aliases, a callable output
    count and an op with no gradient, eager, hybridized and traced."""

    def __init__(self, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.dense = mx.gluon.nn.Dense(6, flatten=False)

    def hybrid_forward(self, F, x):
        h = self.dense(x)
        a, b = F.split(h, num_outputs=2, axis=-1)
        idx = F.argmax(a, axis=-1, keepdims=True)
        return F.concat(F.relu(a) * 2.0, F.square(b),
                        F.broadcast_mul(idx, F.ones_like(b)), dim=-1)


def test_ops_through_f_inside_hybrid_forward():
    x = np.random.RandomState(5).randn(2, 3, 4).astype(np.float32)
    with mx.cpu():
        net = _UsesNewOps(prefix="uses_")
        net.initialize(mx.init.Xavier())
        xs = mx.nd.array(x)
        eager = net(xs).asnumpy()
        xs.attach_grad()
        with mx.autograd.record():
            out = net(xs)
        out.backward()
        grad = xs.grad.asnumpy()
        net.hybridize()
        net(xs)
        hyb = net(xs).asnumpy()
        traced = net(mx.sym.var("data"))
        params = {p.name: p.data() for p in net.collect_params().values()}
        sym_out = traced.eval_with({"data": xs}, params).asnumpy()
    np.testing.assert_array_equal(hyb, eager)
    np.testing.assert_allclose(sym_out, eager, rtol=RTOL, atol=ATOL)
    assert np.isfinite(grad).all() and np.abs(grad).sum() > 0
