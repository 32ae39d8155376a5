"""The port's loss heads, shape and type inference, binding and
``Executor`` (mxnet_tpu_torch/ops/nn.py SoftmaxOutput,
ops/output_ops.py, symbol/symbol.py, executor.py) against the JAX
package's on the CPU.

Each case feeds the same numpy inputs, from a seed, to a symbol bound
in both packages: the forward outputs and the gradients of a training
backward agree at float32 rtol = atol = 1e-6 (a softmax and an
elementwise gradient, the same arithmetic in both). The executor's
``grad_req`` modes, BatchNorm's running statistics written in train
mode, and ``reshape`` are held against the JAX executor and against the
port's own autograd of the same ops."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError, dtype_name

CPU = mx.cpu()
TOL = 1e-6          # the heads' forward and backward, float32
GRAPH_TOL = 1e-5    # a small conv + BatchNorm + FC graph, float32


def _bind_pair(build, shapes, grad_req="write"):
    """The symbol ``build(sym)`` bound in both packages."""
    jex = build(jmx.sym).simple_bind(jmx.cpu(), grad_req=grad_req, **shapes)
    ex = build(mx.sym).simple_bind(CPU, grad_req=grad_req, **shapes)
    return jex, ex


def _run(jex, ex, feed, out_grads=None, is_train=True):
    jouts = jex.forward(is_train=is_train,
                        **{k: jmx.nd.array(v) for k, v in feed.items()})
    outs = ex.forward(is_train=is_train,
                      **{k: mx.nd.array(v, ctx=CPU) for k, v in feed.items()})
    if is_train:
        jex.backward(None if out_grads is None else
                     [jmx.nd.array(g) for g in out_grads])
        ex.backward(None if out_grads is None else
                    [mx.nd.array(g, ctx=CPU) for g in out_grads])
    return [o.asnumpy() for o in jouts], [o.asnumpy() for o in outs]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


SOFTMAX_CASES = [
    dict(),
    dict(normalization="batch"),
    dict(normalization="valid"),
    dict(use_ignore=True, ignore_label=2.0),
    dict(use_ignore=True, ignore_label=2.0, normalization="valid"),
    dict(use_ignore=True, ignore_label=-1.0, normalization="batch"),
    dict(grad_scale=0.5, smooth_alpha=0.1),
    dict(multi_output=True),
    dict(multi_output=True, normalization="valid", use_ignore=True,
         ignore_label=1.0),
    dict(out_grad=True),
]


@pytest.mark.parametrize("kw", SOFTMAX_CASES,
                         ids=[str(sorted(k.items())) for k in SOFTMAX_CASES])
def test_softmax_output_forward_and_backward_match_jax(kw):
    rs = np.random.RandomState(0)
    multi = kw.get("multi_output", False)
    dshape = (4, 5, 3) if multi else (6, 5)
    lshape = (4, 3) if multi else (6,)
    x = rs.randn(*dshape).astype(np.float32)
    lab = rs.randint(0, 5, lshape).astype(np.float32)
    if kw.get("ignore_label") == -1.0:
        lab[0] = -1.0
    head = rs.randn(*dshape).astype(np.float32)

    def build(sym):
        return sym.SoftmaxOutput(sym.var("data"), sym.var("label"),
                                 name="sm", **kw)

    jex, ex = _bind_pair(build, {"data": dshape, "label": lshape},
                         grad_req={"data": "write"})
    jo, o = _run(jex, ex, {"data": x, "label": lab}, [head])
    _close(o[0], jo[0])
    _close(ex.grad_dict["data"].asnumpy(), jex.grad_dict["data"].asnumpy())
    assert set(ex.grad_dict) == {"data"}   # the label gets no gradient


def test_softmax_output_names_its_label_and_aliases_softmax():
    net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=4, name="fc")
    for op in (mx.sym.SoftmaxOutput, mx.sym.Softmax):
        head = op(net, name="softmax")
        jhead = getattr(jmx.sym, op.__name__)(
            jmx.sym.FullyConnected(jmx.sym.var("data"), num_hidden=4,
                                   name="fc"), name="softmax")
        assert head.list_arguments() == jhead.list_arguments() == [
            "data", "fc_weight", "fc_bias", "softmax_label"]
        assert head.infer_shape(data=(3, 7))[0][-1] == (3,)
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    out = mx.nd.SoftmaxOutput(mx.nd.array(x, ctx=CPU),
                              mx.nd.array([0.0, 1.0, 2.0], ctx=CPU))
    _close(out.asnumpy(), torch.softmax(torch.from_numpy(x), -1).numpy())


OUTPUT_CASES = [
    ("LinearRegressionOutput", dict(), (6, 3), (6, 3)),
    ("LinearRegressionOutput", dict(grad_scale=2.0), (6, 1), (6,)),
    ("MAERegressionOutput", dict(), (6, 3), (6, 3)),
    ("MAERegressionOutput", dict(grad_scale=0.5), (5, 2), (5, 2)),
    ("LogisticRegressionOutput", dict(), (6, 3), (6, 3)),
    ("LogisticRegressionOutput", dict(grad_scale=3.0), (4, 1), (4,)),
    ("SVMOutput", dict(), (6, 4), (6,)),
    ("SVMOutput", dict(margin=0.5, regularization_coefficient=2.0,
                       use_linear=True), (6, 4), (6,)),
    ("SVMOutput", dict(use_linear=False, margin=2.0), (5, 3), (5,)),
]


@pytest.mark.parametrize("op,kw,dshape,lshape", OUTPUT_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(OUTPUT_CASES)])
def test_output_ops_forward_and_backward_match_jax(op, kw, dshape, lshape):
    rs = np.random.RandomState(2)
    x = rs.randn(*dshape).astype(np.float32)
    if op == "SVMOutput":
        lab = rs.randint(0, dshape[-1], lshape).astype(np.float32)
    elif op == "LogisticRegressionOutput":
        lab = (rs.rand(*lshape) > 0.5).astype(np.float32)
    else:
        lab = rs.randn(*lshape).astype(np.float32)
    head = rs.randn(*dshape).astype(np.float32)

    def build(sym):
        return getattr(sym, op)(sym.var("data"), sym.var("label"),
                                name="head", **kw)

    jex, ex = _bind_pair(build, {"data": dshape, "label": lshape},
                         grad_req={"data": "write"})
    jo, o = _run(jex, ex, {"data": x, "label": lab}, [head])
    _close(o[0], jo[0])
    _close(ex.grad_dict["data"].asnumpy(), jex.grad_dict["data"].asnumpy())


@pytest.mark.parametrize("kw", [dict(), dict(sparseness_target=0.3,
                                             penalty=0.01)])
def test_kl_sparse_reg_adds_its_penalty_to_the_head_gradient(kw):
    rs = np.random.RandomState(3)
    x = rs.rand(5, 4).astype(np.float32)
    head = rs.randn(5, 4).astype(np.float32)

    def build(sym):
        return sym.IdentityAttachKLSparseReg(sym.var("data"), name="kl",
                                             **kw)

    jex, ex = _bind_pair(build, {"data": (5, 4)})
    jo, o = _run(jex, ex, {"data": x}, [head])
    _close(o[0], x)
    _close(ex.grad_dict["data"].asnumpy(), jex.grad_dict["data"].asnumpy())


def _convnet(sym):
    """A small conv + BatchNorm + FC graph with a SoftmaxOutput head."""
    net = sym.Convolution(sym.var("data"), num_filter=4, kernel=(3, 3),
                          pad=(1, 1), name="conv")
    net = sym.BatchNorm(net, fix_gamma=False, name="bn")
    net = sym.Activation(net, act_type="relu", name="relu")
    net = sym.FullyConnected(net, num_hidden=3, name="fc")
    return sym.SoftmaxOutput(net, sym.var("softmax_label"), name="softmax")


def _set_params(jex, ex, seed):
    rs = np.random.RandomState(seed)
    for name, arr in ex.arg_dict.items():
        if name in ("data", "softmax_label"):
            continue
        v = (rs.randn(*arr.shape) * 0.3).astype(np.float32)
        arr._data.copy_(torch.from_numpy(v))
        jex.arg_dict[name]._rebind(jmx.nd.array(v)._data)
    for name, arr in ex.aux_dict.items():
        v = rs.rand(*arr.shape).astype(np.float32) + 0.5
        arr._data.copy_(torch.from_numpy(v))
        jex.aux_dict[name]._rebind(jmx.nd.array(v)._data)


def test_infer_shape_type_and_simple_bind_match_jax():
    shapes = {"data": (2, 3, 5, 5), "softmax_label": (2,)}
    port, jax = _convnet(mx.sym), _convnet(jmx.sym)
    assert port.list_arguments() == jax.list_arguments()
    assert port.list_auxiliary_states() == jax.list_auxiliary_states() == [
        "bn_moving_mean", "bn_moving_var"]
    assert port.infer_shape(**shapes) == jax.infer_shape(**shapes)
    assert port.infer_shape_partial(softmax_label=(2,)) == \
        jax.infer_shape_partial(softmax_label=(2,)) == (None, None, None)
    for hints in ({"data": "float32"}, {"data": "float16"}):
        got = port.infer_type(**hints)
        want = jax.infer_type(**hints)
        assert [[dtype_name(t) for t in g] for g in got] == \
            [[np.dtype(t).name for t in w] for w in want]
    ex = port.simple_bind(CPU, **shapes)
    jex = jax.simple_bind(jmx.cpu(), **shapes)
    for mine, theirs in ((ex.arg_dict, jex.arg_dict),
                         (ex.aux_dict, jex.aux_dict),
                         (ex.grad_dict, jex.grad_dict)):
        assert list(mine) == list(theirs)
        assert [a.shape for a in mine.values()] == \
            [tuple(a.shape) for a in theirs.values()]
        assert all(a.dtype == torch.float32 for a in mine.values())
        assert all(a.context == CPU for a in mine.values())


def test_simple_bind_takes_one_context_and_eval_runs_the_graph():
    net = _convnet(mx.sym)
    with pytest.raises(MXNetError, match="A4"):
        net.simple_bind([mx.cpu(0), mx.cpu(1)], data=(2, 3, 5, 5))
    ex = net.simple_bind([CPU], data=(2, 3, 5, 5))
    feed = {n: mx.nd.array(np.ones(a.shape, np.float32), ctx=CPU)
            for n, a in ex.arg_dict.items()}
    feed.update((n, a) for n, a in ex.aux_dict.items())
    out = net.eval(**feed)
    assert isinstance(out, list) and out[0].shape == (2, 3)


@pytest.mark.parametrize("grad_req", ["write", "add", "null"])
def test_executor_matches_jax_by_grad_req(grad_req):
    shapes = {"data": (2, 3, 5, 5), "softmax_label": (2,)}
    req = {n: grad_req for n in _convnet(mx.sym).list_arguments()
           if n != "softmax_label"}
    jex, ex = _bind_pair(_convnet, shapes, grad_req=req)
    _set_params(jex, ex, 4)
    rs = np.random.RandomState(5)
    for step in range(2):
        feed = {"data": rs.randn(*shapes["data"]).astype(np.float32),
                "softmax_label": rs.randint(0, 3, 2).astype(np.float32)}
        jo, o = _run(jex, ex, feed)
        _close(o[0], jo[0], GRAPH_TOL)
        assert set(ex.grad_dict) == set(jex.grad_dict)
        for name, g in ex.grad_dict.items():
            _close(g.asnumpy(), jex.grad_dict[name].asnumpy(), GRAPH_TOL)
        # train mode: the running statistics written in place, as the
        # JAX executor's rebind
        for name, a in ex.aux_dict.items():
            _close(a.asnumpy(), jex.aux_dict[name].asnumpy(), GRAPH_TOL)


def test_executor_keeps_its_storage_and_matches_its_own_autograd():
    shapes = {"data": (2, 3, 5, 5), "softmax_label": (2,)}
    jex, ex = _bind_pair(_convnet, shapes)
    _set_params(jex, ex, 6)
    ptrs = {n: a._data.data_ptr() for n, a in ex.arg_dict.items()}
    ptrs.update((n, a._data.data_ptr()) for n, a in ex.aux_dict.items())
    gptrs = {n: a._data.data_ptr() for n, a in ex.grad_dict.items()}
    rs = np.random.RandomState(7)
    x = rs.randn(*shapes["data"]).astype(np.float32)
    y = rs.randint(0, 3, 2).astype(np.float32)
    head = rs.randn(2, 3).astype(np.float32)
    mean0 = ex.aux_dict["bn_moving_mean"].asnumpy()
    # the same ops through the imperative path, under torch.autograd
    w = {n: a._data.clone().requires_grad_(True)
         for n, a in ex.arg_dict.items()
         if n not in ("data", "softmax_label")}
    data = torch.from_numpy(x).requires_grad_(True)
    aux = {n: a._data.clone() for n, a in ex.aux_dict.items()}
    reg = mx.ops.registry
    h = reg.get("Convolution")(data, w["conv_weight"], w["conv_bias"],
                               kernel=(3, 3), pad=(1, 1), num_filter=4)
    h, mean, var = reg.get("BatchNorm")(
        h, w["bn_gamma"], w["bn_beta"], aux["bn_moving_mean"],
        aux["bn_moving_var"], fix_gamma=False, training=True)
    h = reg.get("FullyConnected")(torch.relu(h), w["fc_weight"],
                                  w["fc_bias"], num_hidden=3)
    p = reg.get("SoftmaxOutput")(h, torch.from_numpy(y))
    p.backward(torch.from_numpy(head))
    _, o = _run(jex, ex, {"data": x, "softmax_label": y}, [head])
    _close(o[0], p.detach().numpy(), GRAPH_TOL)
    _close(ex.grad_dict["data"].asnumpy(), data.grad.numpy(), GRAPH_TOL)
    for n, t in w.items():
        _close(ex.grad_dict[n].asnumpy(), t.grad.numpy(), GRAPH_TOL)
    _close(ex.aux_dict["bn_moving_mean"].asnumpy(),
           mean0 * 0.9 + mean.numpy() * 0.1, GRAPH_TOL)
    assert {n: a._data.data_ptr() for n, a in ex.arg_dict.items()} | {
        n: a._data.data_ptr() for n, a in ex.aux_dict.items()} == ptrs
    assert {n: a._data.data_ptr() for n, a in ex.grad_dict.items()} == gptrs
    assert not any(a._data.requires_grad for a in ex.arg_arrays)


def test_inference_forward_leaves_statistics_and_backward_needs_training():
    shapes = {"data": (2, 3, 5, 5), "softmax_label": (2,)}
    jex, ex = _bind_pair(_convnet, shapes)
    _set_params(jex, ex, 8)
    x = np.random.RandomState(9).randn(2, 3, 5, 5).astype(np.float32)
    stats = [a.asnumpy() for a in ex.aux_arrays]
    jo, o = _run(jex, ex, {"data": x}, is_train=False)
    _close(o[0], jo[0], GRAPH_TOL)
    for a, b in zip(ex.aux_arrays, stats):
        np.testing.assert_array_equal(a.asnumpy(), b)
    with pytest.raises(MXNetError, match="forward"):
        ex.backward()


def test_reshape_shares_parameters_and_matches_jax():
    shapes = {"data": (2, 3, 5, 5), "softmax_label": (2,)}
    jex, ex = _bind_pair(_convnet, shapes)
    _set_params(jex, ex, 10)
    new = ex.reshape(allow_up_sizing=True, data=(4, 3, 5, 5),
                     softmax_label=(4,))
    jnew = jex.reshape(data=(4, 3, 5, 5), softmax_label=(4,))
    assert new.arg_dict["data"].shape == (4, 3, 5, 5)
    assert new.arg_dict["conv_weight"] is ex.arg_dict["conv_weight"]
    assert new.aux_dict["bn_moving_var"] is ex.aux_dict["bn_moving_var"]
    rs = np.random.RandomState(11)
    feed = {"data": rs.randn(4, 3, 5, 5).astype(np.float32),
            "softmax_label": rs.randint(0, 3, 4).astype(np.float32)}
    jo, o = _run(jnew, new, feed)
    _close(o[0], jo[0], GRAPH_TOL)
    _close(new.grad_dict["fc_weight"].asnumpy(),
           jnew.grad_dict["fc_weight"].asnumpy(), GRAPH_TOL)


def test_reshape_refuses_unasked_changes_and_up_sizing_as_mxnet():
    """MXNet 1.x's ``Executor.reshape``: an array not named may change
    shape only with ``partial_shaping``; one may grow only with
    ``allow_up_sizing``."""
    ex = _convnet(mx.sym).simple_bind(CPU, data=(4, 3, 5, 5),
                                      softmax_label=(4,))
    with pytest.raises(MXNetError, match="allow_up_sizing"):
        ex.reshape(data=(8, 3, 5, 5), softmax_label=(8,))
    with pytest.raises(MXNetError, match="partial_shaping"):
        ex.reshape(data=(2, 3, 5, 5))      # the label shrinks unasked
    small = ex.reshape(data=(2, 3, 5, 5), softmax_label=(2,))
    part = ex.reshape(partial_shaping=True, data=(2, 3, 5, 5))
    big = ex.reshape(allow_up_sizing=True, data=(8, 3, 5, 5),
                     softmax_label=(8,))
    for new, batch in ((small, 2), (part, 2), (big, 8)):
        assert new.arg_dict["softmax_label"].shape == (batch,)
        assert new.arg_dict["conv_weight"] is ex.arg_dict["conv_weight"]


def test_bind_over_caller_arrays_and_copy_params_from():
    net = _convnet(mx.sym)
    shapes = {"data": (2, 3, 5, 5), "softmax_label": (2,)}
    arg_shapes, _, aux_shapes = net.infer_shape(**shapes)
    rs = np.random.RandomState(12)
    args = [mx.nd.array(rs.randn(*s).astype(np.float32), ctx=CPU)
            for s in arg_shapes]
    grads = [mx.nd.array(np.zeros(s, np.float32), ctx=CPU)
             for s in arg_shapes]
    auxs = [mx.nd.array(np.ones(s, np.float32), ctx=CPU) for s in aux_shapes]
    ex = net.bind(CPU, args, args_grad=grads, grad_req="add",
                  aux_states=auxs)
    assert ex.arg_arrays[1] is args[1] and ex.grad_arrays[1] is grads[1]
    ex.forward(is_train=True)
    ex.backward()
    once = grads[1].asnumpy()
    ex.forward(is_train=True)
    ex.backward()
    _close(grads[1].asnumpy(), 2 * once, GRAPH_TOL)   # "add" accumulates
    ex.copy_params_from({"fc_bias": mx.nd.array([1.0, 2.0, 3.0], ctx=CPU)})
    np.testing.assert_array_equal(args[-2].asnumpy(), [1.0, 2.0, 3.0])
    with pytest.raises(MXNetError, match="not bound"):
        ex.copy_params_from({"nope": args[0]})
    ex.copy_params_from({"nope": args[0]}, allow_extra_params=True)
    with pytest.raises(MXNetError, match="bind is missing"):
        net.bind(CPU, args[:2])
