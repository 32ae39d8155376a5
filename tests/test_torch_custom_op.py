"""User-defined operators in the port against the JAX package, on the
CPU: the ``Custom`` op with ``mx.operator`` (``CustomOp``,
``CustomOpProp``, ``register``), ``autograd.Function``,
``mark_variables`` and ``get_symbol``.

Each operator is written once, as a function of the ``mx`` module
(``define``), so each package registers its own subclasses of the same
code: MXNet 1.x's ``example/numpy-ops/custom_softmax.py`` (numpy on the
host, a loss head with ``need_top_grad=False``), a sigmoid on NDArrays, a
two-output op and one that takes a constructor keyword and keeps an
auxiliary state. Held: eager outputs and gradients, ``mx.sym.Custom``
through ``simple_bind`` and symbol JSON both ways, a hybridized block,
and a small ``Module.fit`` with the custom softmax head (against the JAX
package's, and against SoftmaxOutput with ``normalization="null"``,
whose gradient MXNet's custom softmax computes).

The host-op rule: a body that calls ``Custom`` runs uncaptured by a
decision made before any capture (an executor from its graph, a
hybridized block or a trainer's step from its first call) and counts
under its reason in ``compile.stats()``, with nothing captured and no
``CaptureError``. Fault C22, kept in the reference: the JAX
``mx.sym.Custom`` leaves an argument it was not given out of the graph,
and its shape inference does not ask the prop for a variable input's
shape; the port, as MXNet 1.x, makes the argument a variable
``<name>_<argument>`` (``softmax_label``) whose shape the prop's
``infer_shape`` gives. Fault C24, kept in the reference: the JAX
``asnumpy()`` returns a read-only array, so ``custom_softmax.py``'s
backward, which writes into it, fails there; the port's is a writable
copy, as MXNet's (the shared body here copies it once more).

Tolerances: float32 forwards and gradients at rtol 1e-5, atol 1e-6 (the
same numpy code in both packages, sums in other orders around it); the
fits' parameters at rtol 1e-4, atol 1e-5 after 8 steps.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import compile as mxc
from mxnet_tpu_torch.parallel import DeviceMesh, ShardedTrainer

TOL = dict(rtol=1e-5, atol=1e-6)
FIT_TOL = dict(rtol=1e-4, atol=1e-5)
CPU = mx.cpu()


def define(m):
    """Register this file's operators in package ``m`` (idempotent)."""

    class Softmax(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))
            self.assign(out_data[0], req[0], m.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            label = in_data[1].asnumpy().ravel().astype(int)
            # a copy: the JAX package's asnumpy() is read-only (C24);
            # custom_softmax.py writes into it, as MXNet's is a copy
            y = np.array(out_data[0].asnumpy())
            y[np.arange(label.shape[0]), label] -= 1.0
            self.assign(in_grad[0], req[0], m.nd.array(y))

    @m.operator.register("t_softmax")
    class SoftmaxProp(m.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class Sigmoid(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        1.0 / (1.0 + m.nd.exp(-in_data[0])))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    @m.operator.register("t_sigmoid")
    class SigmoidProp(m.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    class Two(m.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * 2)
            self.assign(out_data[1], req[1], in_data[0] * in_data[1])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0] * 2 + out_grad[1] * in_data[1])
            self.assign(in_grad[1], req[1], out_grad[1] * in_data[0])

    @m.operator.register("t_two")
    class TwoProp(m.operator.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["double", "product"]

        def create_operator(self, ctx, shapes, dtypes):
            return Two()

    class Scale(m.operator.CustomOp):
        def __init__(self, factor):
            self.factor = factor

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        in_data[0] * self.factor + aux[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * self.factor)

    @m.operator.register("t_scale")
    class ScaleProp(m.operator.CustomOpProp):
        def __init__(self, factor="1.0"):
            super().__init__()
            self.factor = float(factor)

        def list_auxiliary_states(self):
            return ["shift"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [in_shape[0][1:]]

        def create_operator(self, ctx, shapes, dtypes):
            return Scale(self.factor)


define(mx)
define(jmx)


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _port_call(arrays, grad_of, head, **kw):
    """Outputs and the gradients of ``sum(out * head)`` for the inputs
    ``grad_of`` (indices), in the port."""
    with mx.cpu():
        nds = [mx.nd.array(a) for a in arrays]
        for i in grad_of:
            nds[i].attach_grad()
        with mx.autograd.record():
            out = mx.nd.Custom(*nds, **kw)
            outs = out if isinstance(out, (list, tuple)) else [out]
            loss = sum((o * mx.nd.array(h)).sum() for o, h in zip(outs, head))
        loss.backward()
        return [o.asnumpy() for o in outs], [nds[i].grad.asnumpy()
                                             for i in grad_of]


def _jax_call(arrays, grad_of, head, **kw):
    nds = [jmx.nd.array(a) for a in arrays]
    for i in grad_of:
        nds[i].attach_grad()
    with jmx.autograd.record():
        out = jmx.nd.Custom(*nds, **kw)
        outs = out if isinstance(out, (list, tuple)) else [out]
        loss = sum((o * jmx.nd.array(h)).sum() for o, h in zip(outs, head))
    loss.backward()
    return [o.asnumpy() for o in outs], [nds[i].grad.asnumpy()
                                         for i in grad_of]


CALLS = {
    "softmax": ([_x(1, 6, 5), np.array([0, 4, 2, 1, 3, 3], np.float32)],
                (0,), dict(op_type="t_softmax")),
    "sigmoid": ([_x(2, 4, 7)], (0,), dict(op_type="t_sigmoid")),
    "two_outputs": ([_x(3, 3, 4), _x(4, 3, 4)], (0, 1),
                    dict(op_type="t_two")),
    "keyword_and_aux": ([_x(5, 3, 4), _x(6, 4)], (0,),
                        dict(op_type="t_scale", factor="2.5")),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_custom_forward_and_gradient_match_jax(name):
    arrays, grad_of, kw = CALLS[name]
    with mx.cpu():
        n_out = len(mx.operator.get_all_registered_operators()) and (
            2 if name == "two_outputs" else 1)
    head = [_x(10 + i, *arrays[0].shape) for i in range(n_out)]
    got, ggot = _port_call(arrays, grad_of, head, **kw)
    want, gwant = _jax_call(arrays, grad_of, head, **kw)
    assert len(got) == len(want) == n_out
    for a, b in zip(got + ggot, want + gwant):
        np.testing.assert_allclose(a, b, **TOL)


def test_custom_softmax_gradient_ignores_the_head_gradient():
    """need_top_grad=False: the loss head's backward is y - onehot
    whatever head gradient arrives."""
    arrays, grad_of, kw = CALLS["softmax"]
    ones = [np.ones(arrays[0].shape, np.float32)]
    twos = [2 * ones[0]]
    y, g1 = _port_call(arrays, grad_of, ones, **kw)
    _, g2 = _port_call(arrays, grad_of, twos, **kw)
    want = y[0].copy()
    want[np.arange(6), arrays[1].astype(int)] -= 1
    np.testing.assert_allclose(g1[0], want, **TOL)
    np.testing.assert_array_equal(g1[0], g2[0])


def test_c24_asnumpy_is_a_writable_copy_unlike_the_jax_package():
    """custom_softmax.py's backward writes into ``out_data[0].asnumpy()``:
    it runs in the port (and MXNet 1.x), not in the JAX package."""
    with mx.cpu():
        a = mx.nd.array([1.0, 2.0])
        host = a.asnumpy()
        host[0] = 5.0
        assert host.flags.writeable and a.asnumpy()[0] == 1.0
    assert not jmx.nd.array([1.0, 2.0]).asnumpy().flags.writeable


def test_operator_api_matches_jax():
    for m in (mx, jmx):
        names = m.operator.get_all_registered_operators()
        assert {"t_softmax", "t_sigmoid", "t_two", "t_scale"} <= set(names)
        prop = m.operator.CustomOpProp()
        assert prop.list_arguments() == ["data"]
        assert prop.infer_shape([[2, 3]]) == ([[2, 3]], [[2, 3]], [])
        with pytest.raises(TypeError):
            m.operator.register("t_bad")(object)
    op = mx.operator.CustomOp()
    with mx.cpu():
        dst = mx.nd.ones((2,))
        op.assign(dst, "add", mx.nd.ones((2,)))
        op.assign(dst, "null", mx.nd.zeros((2,)))
        np.testing.assert_array_equal(dst.asnumpy(), [2, 2])
        op.assign(dst, "write", mx.nd.zeros((2,)))
        np.testing.assert_array_equal(dst.asnumpy(), [0, 0])
        with pytest.raises(ValueError, match="not registered"):
            mx.nd.Custom(mx.nd.ones((2,)), op_type="t_nothing")


def _softmax_symbol(m, label):
    data = m.sym.var("data")
    fc = m.sym.FullyConnected(data, num_hidden=4, name="fc")
    if label:
        return m.sym.Custom(fc, m.sym.var("softmax_label"),
                            op_type="t_softmax", name="softmax")
    return m.sym.Custom(fc, op_type="t_softmax", name="softmax")


def test_c22_sym_custom_names_a_missing_argument_unlike_the_jax_package():
    port = _softmax_symbol(mx, label=False)
    assert port.list_arguments() == ["data", "fc_weight", "fc_bias",
                                     "softmax_label"]
    assert port.list_outputs() == ["softmax_output"]
    assert port.infer_shape(data=(6, 3)) == (
        [(6, 3), (4, 3), (4,), (6,)], [(6, 4)], [])
    assert _softmax_symbol(jmx, label=False).list_arguments() == [
        "data", "fc_weight", "fc_bias"]
    assert _softmax_symbol(jmx, label=True).list_arguments() == \
        port.list_arguments()
    aux = mx.sym.Custom(mx.sym.var("x"), op_type="t_scale", name="sc")
    assert aux.list_auxiliary_states() == ["sc_shift"]


def test_sym_custom_through_simple_bind_and_json_both_ways_match_jax():
    rs = np.random.RandomState(0)
    feed = {"data": rs.randn(6, 3).astype(np.float32),
            "fc_weight": rs.randn(4, 3).astype(np.float32),
            "fc_bias": rs.randn(4).astype(np.float32),
            "softmax_label": np.array([0, 1, 2, 3, 1, 0], np.float32)}
    port = _softmax_symbol(mx, label=False)
    jsym = _softmax_symbol(jmx, label=True)
    results = []
    for m, sym in ((mx, port), (jmx, jsym), (mx, mx.sym.load_json(
            jsym.tojson())), (jmx, jmx.sym.load_json(port.tojson()))):
        # the JAX executor does not ask the prop for the label's shape
        # (C22): it is given to both
        ex = sym.simple_bind(m.cpu(), data=(6, 3), softmax_label=(6,))
        for k, v in feed.items():
            ex.arg_dict[k][:] = m.nd.array(v, ctx=m.cpu())
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        results.append((out, ex.grad_dict["fc_weight"].asnumpy(),
                        ex.grad_dict["fc_bias"].asnumpy()))
    for res in results[1:]:
        for a, b in zip(results[0], res):
            np.testing.assert_allclose(a, b, **TOL)


def test_the_executor_runs_a_graph_with_custom_uncaptured_by_its_graph():
    mxc.reset_stats()
    sym = _softmax_symbol(mx, label=False)
    with mx.cpu():
        ex = sym.simple_bind(data=(6, 3))
        for _ in range(3):
            ex.forward(is_train=True)
            ex.backward()
        ex.forward(is_train=False)
    st = mxc.stats()["executor"]
    assert st["uncaptured"] == {
        "host op Custom(op_type='t_softmax')": 4}
    assert (st["misses"], st["hits"], st["compiles"], st["captures"]) == \
        (2, 2, 0, 0)
    kinds = [e["kind"] for e in ex._fwd_train.stats()["entries"]]
    assert kinds == ["host"]


class _Net:
    @staticmethod
    def make(m, hybridize):
        class Net(m.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.fc = m.gluon.nn.Dense(5, in_units=4)

            def hybrid_forward(self, F, x):
                return F.Custom(self.fc(x), op_type="t_sigmoid")

        net = Net(prefix="net_")
        if m is mx:
            net.initialize(ctx=CPU)
        else:
            net.initialize()
        if hybridize:
            net.hybridize()
        return net


def test_a_hybridized_block_with_custom_matches_jax_and_runs_uncaptured():
    x = _x(20, 3, 4)
    jnet = _Net.make(jmx, hybridize=True)
    net = _Net.make(mx, hybridize=True)
    jw = {n: p.data().asnumpy()
          for n, p in jnet._collect_params_with_structure().items()}
    from mxnet_tpu_torch.convert import load_jax_params

    load_jax_params(net, jw)
    mxc.reset_stats()
    with mx.cpu():
        xs = mx.nd.array(x)
        first = net(xs).asnumpy()
        for _ in range(2):
            net(xs)
        with mx.autograd.record():
            loss = net(xs).sum()
        loss.backward()
    with jmx.autograd.record():
        jloss = jnet(jmx.nd.array(x)).sum()
    jloss.backward()
    np.testing.assert_allclose(first, jnet(jmx.nd.array(x)).asnumpy(), **TOL)
    for name, p in net._collect_params_with_structure().items():
        jp = jnet._collect_params_with_structure()[name]
        np.testing.assert_allclose(p.grad().asnumpy(), jp.grad().asnumpy(),
                                   **TOL)
    st = mxc.stats()["cachedop"]
    assert st["uncaptured"] == {"host op Custom(op_type='t_sigmoid')": 4}
    assert st["captures"] == st["replays"] == st["compiles"] == 0


def test_a_sharded_trainer_step_with_custom_runs_uncaptured():
    net = _Net.make(mx, hybridize=False)
    rs = np.random.RandomState(0)
    x, y = rs.randn(8, 4).astype(np.float32), rs.randint(0, 5, 8)
    st = ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                        {"learning_rate": 0.1},
                        mesh=DeviceMesh({"dp": 1}, devices=[CPU]))
    mxc.reset_stats()
    losses = [float(st.step(mx.nd.array(x, ctx=CPU),
                            mx.nd.array(y, ctx=CPU)).asscalar())
              for _ in range(3)]
    site = mxc.stats()["trainer"]
    assert site["uncaptured"] == {"host op Custom(op_type='t_sigmoid')": 3}
    assert site["compiles"] == site["captures"] == 0
    assert losses[-1] < losses[0]


def _fit(m, head, params, x, y):
    data = m.sym.var("data")
    h = m.sym.Activation(m.sym.FullyConnected(data, num_hidden=16,
                                              name="fc1"), act_type="relu")
    fc = m.sym.FullyConnected(h, num_hidden=4, name="fc2")
    if head == "Custom":
        sym = m.sym.Custom(fc, m.sym.var("softmax_label"),
                           op_type="t_softmax", name="softmax")
    else:
        sym = m.sym.SoftmaxOutput(fc, m.sym.var("softmax_label"),
                                  name="softmax", normalization="null")
    it = m.io.NDArrayIter(x, y, batch_size=8)
    mod = m.mod.Module(sym, context=m.cpu())
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "rescale_grad": 1 / 8},
            arg_params={k: m.nd.array(v) for k, v in params.items()},
            eval_metric="acc")
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_fit_with_the_custom_softmax_head_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(32, 10).astype(np.float32)
    y = rs.randint(0, 4, 32).astype(np.float32)
    params = {"fc1_weight": rs.randn(16, 10).astype(np.float32) * 0.3,
              "fc1_bias": np.zeros(16, np.float32),
              "fc2_weight": rs.randn(4, 16).astype(np.float32) * 0.3,
              "fc2_bias": np.zeros(4, np.float32)}
    with mx.cpu():
        got = _fit(mx, "Custom", params, x, y)
        softmax_output = _fit(mx, "SoftmaxOutput", params, x, y)
    want = _fit(jmx, "Custom", params, x, y)
    for k in params:
        assert not np.allclose(got[k], params[k])
        np.testing.assert_allclose(got[k], want[k], **FIT_TOL)
        np.testing.assert_allclose(got[k], softmax_output[k], **FIT_TOL)


# ------------------------------------------- autograd.Function and friends --

def _function(m):
    class Scaled(m.autograd.Function):
        """Two outputs: ``x * y`` and ``exp(x)``; the second input's
        gradient is returned as None."""

        def forward(self, x, y):
            e = m.nd.exp(x)
            self.save_for_backward(x, y, e)
            return x * y, e

        def backward(self, d0, d1):
            x, y, e = self.saved_tensors
            return d0 * y + d1 * e, None

    return Scaled


def test_autograd_function_matches_jax():
    x, y = _x(30, 3, 4), _x(31, 3, 4)
    h0, h1 = _x(32, 3, 4), _x(33, 3, 4)
    res = []
    for m, ctx in ((mx, mx.cpu()), (jmx, None)):
        xs = m.nd.array(x) if ctx is None else m.nd.array(x, ctx=ctx)
        ys = m.nd.array(y) if ctx is None else m.nd.array(y, ctx=ctx)
        xs.attach_grad()
        with m.autograd.record():
            a, b = _function(m)()(xs, ys)
            loss = (a * m.nd.array(h0, **({} if ctx is None else
                                          {"ctx": ctx}))).sum() + \
                (b * m.nd.array(h1, **({} if ctx is None else
                                       {"ctx": ctx}))).sum()
        loss.backward()
        res.append((a.asnumpy(), b.asnumpy(), xs.grad.asnumpy()))
    for p, j in zip(*res):
        np.testing.assert_allclose(p, j, **TOL)


def test_autograd_function_single_output_and_outside_record():
    class Cube(mx.autograd.Function):
        def forward(self, x):
            self.save_for_backward(x)
            return x * x * x

        def backward(self, dy):
            (x,) = self.saved_tensors
            return 3 * x * x * dy

    with mx.cpu():
        x = mx.nd.array([1.0, 2.0])
        out = Cube()(x)
        assert isinstance(out, mx.nd.NDArray)
        np.testing.assert_array_equal(out.asnumpy(), [1, 8])
        x.attach_grad()
        with mx.autograd.record():
            y = Cube()(x)
        y.backward()
        np.testing.assert_array_equal(x.grad.asnumpy(), [3, 12])


@pytest.mark.parametrize("req", ["write", "add"])
def test_mark_variables_matches_jax(req):
    x = _x(40, 5)
    res = []
    for m in (mx, jmx):
        kw = {"ctx": mx.cpu()} if m is mx else {}
        v = m.nd.array(x, **kw)
        g = m.nd.ones((5,), **kw)
        m.autograd.mark_variables([v], [g], grad_reqs=req)
        for _ in range(2):
            with m.autograd.record():
                loss = (v * v).sum()
            loss.backward()
        res.append((g.asnumpy() if m is jmx else v.grad.asnumpy(),
                    v.grad.asnumpy()))
    np.testing.assert_allclose(res[0][1], res[1][1], **TOL)
    want = 2 * x if req == "write" else 1 + 4 * x
    np.testing.assert_allclose(res[0][1], want, **TOL)
    np.testing.assert_allclose(res[0][0], want, **TOL)


def test_get_symbol_raises_in_both_packages():
    for m in (mx, jmx):
        with pytest.raises(NotImplementedError):
            m.autograd.get_symbol(None)


def test_a_host_op_called_inside_a_capture_raises_naming_itself(monkeypatch):
    """The rule decides before any capture; a host op that a capture
    meets anyway (a body whose first call did not reach it) raises
    ``HostOpInCapture`` naming the op rather than failing inside it."""
    from types import SimpleNamespace

    from mxnet_tpu_torch.ops import registry as reg

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    card_array = SimpleNamespace(is_cuda=True)
    with pytest.raises(reg.HostOpInCapture, match="t_sigmoid"):
        reg.get("Custom")(card_array, op_type="t_sigmoid")


def test_watching_host_ops_nests_and_sees_each_op_once():
    from mxnet_tpu_torch.ops import registry as reg

    with mx.cpu(), reg.watching_host_ops() as outer:
        x = mx.nd.ones((2, 3))
        with reg.watching_host_ops() as inner:
            mx.nd.Custom(x, op_type="t_sigmoid")
        mx.nd.Custom(x, op_type="t_sigmoid")
        mx.nd.Custom(x, mx.nd.ones((3,)), op_type="t_scale", factor="2")
        mx.nd.relu(x)
    assert inner == ["Custom(op_type='t_sigmoid')"]
    assert outer == ["Custom(op_type='t_sigmoid')",
                     "Custom(op_type='t_scale')"]
