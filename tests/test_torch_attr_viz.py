"""``AttrScope`` (``mxnet_tpu_torch/attribute.py`` and its hooks in the
symbol layer), the graph-pass registry (``Symbol.optimize_for``,
``register_pass``, ``HybridBlock.optimize_for``) and ``print_summary``
(``mxnet_tpu_torch/visualization.py``), each against the JAX package on
the CPU: the cases of ``tests/test_symbol.py:241-342`` run in both
packages, and the summary's text is compared character for character.
No tolerance: attributes, pass results and text are equal or not."""
import contextlib
import io
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.symbol import symbol as JS
from mxnet_tpu_torch.symbol import symbol as S

BOTH = pytest.mark.parametrize("m", [jmx, mx], ids=["jax", "port"])


@BOTH
def test_attr_scope_lands_nests_and_stays_out_of_the_ops(m):
    data = m.sym.var("data")
    with m.AttrScope(ctx_group="stage1", __lr_mult__="0.1"):
        w = m.sym.var("w")
        net = m.sym.FullyConnected(data, weight=w, num_hidden=3,
                                   no_bias=True)
        with m.AttrScope(ctx_group="stage2"):
            inner = m.sym.var("b")
    assert w.attr("ctx_group") == "stage1"
    assert w.attr("__ctx_group__") == "stage1"
    assert w.attr("lr_mult") == "0.1"
    assert net.attr("ctx_group") == "stage1"
    assert inner.attr("ctx_group") == "stage2"
    assert inner.attr("lr_mult") == "0.1"
    assert m.sym.var("o").attr("ctx_group") is None
    exe = net.simple_bind(m.cpu(), data=(2, 5), w=(3, 5))
    exe.forward(is_train=False, data=m.nd.ones((2, 5), ctx=m.cpu()),
                w=m.nd.ones((3, 5), ctx=m.cpu()))
    assert exe.outputs[0].shape == (2, 3)
    back = m.sym.load_json(net.tojson())
    assert back.attr("ctx_group") == "stage1"
    assert back.attr("lr_mult") == "0.1"


@BOTH
def test_user_attrs_win_and_a_reused_scope_leaks_nothing(m):
    with m.AttrScope(ctx_group="a"):
        w = m.sym.var("w", attr={"ctx_group": "b"})
    assert w.attr("ctx_group") == "b" and w.attr("__ctx_group__") == "b"
    s = m.AttrScope(a="1")
    with m.AttrScope(b="2"):
        with s:
            pass
    with s:
        v = m.sym.var("x2")
    assert v.attr("b") is None and v.attr("a") == "1"
    with pytest.raises(ValueError, match="string"):
        m.AttrScope(lr_mult=0.1)


def test_attrs_and_their_json_equal_the_jax_packages():
    def build(m):
        data = m.sym.var("data")
        with m.AttrScope(ctx_group="dev1", __wd_mult__="0.0"):
            fc = m.sym.FullyConnected(data, num_hidden=4, name="fc")
        return m.sym.Activation(fc, act_type="relu", name="act")

    port, jax = build(mx), build(jmx)
    assert port.attr_dict() == jax.attr_dict()
    fc = port.get_internals()["fc_output"]
    assert fc.list_attr() == jax.get_internals()["fc_output"].list_attr()
    assert fc.attr("ctx_group") == "dev1"
    nodes = {n["name"]: n.get("attrs", {})
             for n in json.loads(port.tojson())["nodes"]}
    jnodes = {n["name"]: n.get("attrs", {})
              for n in json.loads(jax.tojson())["nodes"]}
    assert nodes == jnodes
    port._set_attr(force_mirroring="True")
    out = mx.nd.Activation(mx.nd.ones((2, 2), ctx=mx.cpu()),
                           act_type="relu")
    assert out.shape == (2, 2)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_optimize_for_pass_registry(pkg):
    m, reg = (jmx, JS) if pkg == "jax" else (mx, S)
    data = m.sym.var("data")
    net = m.sym.FullyConnected(data, num_hidden=4)
    assert net.optimize_for("default") is net
    assert net.optimize_for(None) is net
    for p in ("default", "amp", "int8"):
        assert p in reg.list_passes()
    calls = []

    @reg.register_pass("test_identity_pass")
    def _p(sym, args=None, aux=None, **kw):
        calls.append(kw)
        return sym

    try:
        out = net.optimize_for("TEST_identity_pass", custom_opt=3)
        assert out is net and calls[0]["custom_opt"] == 3
        with pytest.raises(m.MXNetError):
            net.optimize_for("not_a_backend")
    finally:
        reg.GRAPH_PASSES.pop("test_identity_pass")
    assert reg.list_passes() == sorted(JS.GRAPH_PASSES)


@BOTH
def test_c31_the_int8_pass_returns_quantize_graphs_pair(m):
    """ROADMAP C31: the ``int8`` pass returns ``(qsym, qspecs)`` in both
    packages (MXNet 1.x's ``optimize_for`` returns a Symbol)."""
    data = m.sym.var("data")
    conv = m.sym.Convolution(data, kernel=(3, 3), num_filter=4,
                             name="conv")
    net = m.sym.FullyConnected(m.sym.Flatten(conv), num_hidden=2,
                               name="fc")
    out = net.optimize_for("int8", ranges={"conv": (-1.0, 1.0),
                                           "fc": (-2.0, 2.0)},
                           excluded_sym_names=["fc"])
    assert isinstance(out, tuple) and len(out) == 2
    qsym, qspecs = out
    ops = [n["op"] for n in json.loads(qsym.tojson())["nodes"]]
    assert "_contrib_quantized_conv" in ops and "FullyConnected" in ops
    assert dict(qspecs) == {"conv_weight": "channel"}


@BOTH
def test_the_amp_pass_is_the_graph_without_parameters(m):
    data = m.sym.var("data")
    net = m.sym.FullyConnected(data, num_hidden=4)
    assert net.optimize_for("amp") is net


def test_hybrid_block_optimize_for_hybridizes_and_runs():
    with mx.cpu():
        net = mx.gluon.nn.Dense(3, in_units=4)
        net.initialize(mx.init.One())
        x = mx.nd.ones((2, 4))
        out = net.optimize_for(x, backend="default")
    assert net._active and out.shape == (2, 3)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 3), 4.0))


def _mnist(m):
    data = m.sym.var("data")
    net = m.sym.Convolution(data, kernel=(3, 3), num_filter=8, name="conv1")
    net = m.sym.Activation(net, act_type="relu")
    net = m.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = m.sym.Flatten(net)
    net = m.sym.FullyConnected(net, num_hidden=64, name="fc1")
    net = m.sym.Activation(net, act_type="relu")
    net = m.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return m.sym.SoftmaxOutput(net, m.sym.var("softmax_label"),
                               name="softmax")


def _bn_net(m):
    data = m.sym.var("data")
    net = m.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                            name="conv1")
    net = m.sym.BatchNorm(net, name="bn1")
    net = m.sym.Activation(net, act_type="relu", name="relu1")
    a = m.sym.Convolution(net, kernel=(1, 1), num_filter=8, name="conv2")
    net = m.sym.elemwise_add(a, net, name="add")
    net = m.sym.Pooling(net, global_pool=True, pool_type="avg",
                        kernel=(1, 1), name="pool")
    net = m.sym.FullyConnected(m.sym.Flatten(net), num_hidden=5, name="fc")
    return m.sym.SoftmaxOutput(net, name="softmax")


def _summary(m, build, shape, **kw):
    buf = io.StringIO()
    with m.name.NameManager(), contextlib.redirect_stdout(buf):
        total = m.visualization.print_summary(build(m), shape=shape, **kw)
    return buf.getvalue(), total


@pytest.mark.parametrize("build,shape,kw", [
    (_mnist, {"data": (64, 1, 28, 28)}, {}),
    (_mnist, None, {}),
    (_bn_net, {"data": (2, 3, 16, 16)}, {}),
    (_bn_net, {"data": (2, 3, 16, 16)},
     {"line_length": 80, "positions": (.5, .7, .8, 1.)}),
])
def test_print_summary_text_equals_the_jax_packages(build, shape, kw):
    got, total = _summary(mx, build, shape, **kw)
    want, jtotal = _summary(jmx, build, shape, **kw)
    assert got == want and total == jtotal
    assert "Total params" in got


@BOTH
def test_plot_network_needs_graphviz(m):
    try:
        import graphviz  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="graphviz"):
            m.visualization.plot_network(_mnist(m))
    else:
        assert m.visualization.plot_network(_mnist(m)) is not None


def test_viz_is_visualization_at_the_top_level():
    assert mx.viz is mx.visualization
    assert mx.AttrScope is mx.attribute.AttrScope
