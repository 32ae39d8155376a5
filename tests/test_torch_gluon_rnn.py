"""``gluon.rnn`` of the port (``mxnet_tpu_torch/gluon/rnn``) against the
JAX package's on the CPU: the cases of ``tests/test_gluon_rnn.py`` (cells
stepped and unrolled, deferred input size, stacks, residual, dropout and
zoneout cells, bidirectional unroll, the fused layers in TNC and NTC,
fused against an unrolled cell, gradients, a short training run), each
built in both packages with one prefix and the JAX weights carried over
by structural name (``convert.load_jax_params``). Dropout and zoneout
run at rate 0 wherever both packages would draw (the generators differ
by design: Philox or mt19937 against threefry). Also: hybridized against
unhybridized, the parameter names, and ``.params`` files crossing both
ways. Tolerances: ``RTOL``/``ATOL`` for values, gradients within
``RTOL`` of each gradient's largest value."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import rnn as jrnn
from mxnet_tpu_torch import autograd as ag
from mxnet_tpu_torch.convert import export_params, load_jax_params
from mxnet_tpu_torch.gluon import rnn

RTOL = ATOL = 1e-5   # float32, the same arithmetic in both packages


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _jax_values(block):
    return {n: p.data().asnumpy() for n, p in
            block._collect_params_with_structure().items()}


def _pair(make_port, make_jax, *first_inputs):
    """The same block in both packages with the JAX block's (seeded)
    weights; ``first_inputs`` (numpy) resolve deferred shapes first."""
    jmx.random.seed(0)
    jb = make_jax()
    jb.initialize(jmx.init.Xavier())
    pb = make_port()
    pb.initialize()
    if first_inputs:
        jb(*[jmx.nd.array(a) for a in first_inputs[:1]],
           *first_inputs[1:])
        pb(*[mx.nd.array(a) for a in first_inputs[:1]],
           *first_inputs[1:])
    load_jax_params(pb, _jax_values(jb))
    return pb, jb


def _assert_same(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name,n_states", [("RNNCell", 1), ("LSTMCell", 2),
                                           ("GRUCell", 1)])
def test_cells_step_match_jax(name, n_states):
    pc, jc = _pair(lambda: getattr(rnn, name)(16, input_size=8,
                                              prefix="cell_"),
                   lambda: getattr(jrnn, name)(16, input_size=8,
                                               prefix="cell_"))
    x = _rand(4, 8)
    ps = [mx.nd.array(_rand(4, 16, seed=i + 1)) for i in range(n_states)]
    js = [jmx.nd.array(_rand(4, 16, seed=i + 1)) for i in range(n_states)]
    pout, pst = pc(mx.nd.array(x), ps)
    jout, jst = jc(jmx.nd.array(x), js)
    assert pout.shape == (4, 16) and len(pst) == n_states
    _assert_same([pout] + pst, [jout] + jst)
    assert len(pc.begin_state(4)) == n_states


@pytest.mark.parametrize("layout,merge", [("NTC", True), ("NTC", False),
                                          ("TNC", True)])
def test_cell_unroll_matches_jax(layout, merge):
    pc, jc = _pair(lambda: rnn.LSTMCell(8, input_size=4, prefix="c_"),
                   lambda: jrnn.LSTMCell(8, input_size=4, prefix="c_"))
    x = _rand(2, 5, 4) if layout == "NTC" else _rand(5, 2, 4)
    pout, pst = pc.unroll(5, mx.nd.array(x), layout=layout,
                          merge_outputs=merge)
    jout, jst = jc.unroll(5, jmx.nd.array(x), layout=layout,
                          merge_outputs=merge)
    if merge:
        assert pout.shape == ((2, 5, 8) if layout == "NTC" else (5, 2, 8))
    else:
        assert len(pout) == 5 and pout[0].shape == (2, 8)
    _assert_same(pout, jout)
    _assert_same(pst, jst)


def test_unroll_with_valid_length_matches_jax():
    pc, jc = _pair(lambda: rnn.GRUCell(6, input_size=3, prefix="g_"),
                   lambda: jrnn.GRUCell(6, input_size=3, prefix="g_"))
    x, vl = _rand(2, 4, 3), np.array([2, 4], np.float32)
    pout, _ = pc.unroll(4, mx.nd.array(x), valid_length=mx.nd.array(vl))
    jout, _ = jc.unroll(4, jmx.nd.array(x), valid_length=jmx.nd.array(vl))
    _assert_same(pout, jout)
    assert float(np.abs(pout.asnumpy()[0, 2:]).max()) == 0.0


def test_deferred_input_size_matches_jax():
    x = _rand(3, 6)
    pc, jc = rnn.GRUCell(8, prefix="g_"), jrnn.GRUCell(8, prefix="g_")
    pc.initialize()
    jc.initialize()
    pc(mx.nd.array(x), pc.begin_state(3))
    jc(jmx.nd.array(x), jc.begin_state(3))
    assert pc.i2h_weight.shape == (24, 6)
    load_jax_params(pc, _jax_values(jc))
    pout, _ = pc(mx.nd.array(x), pc.begin_state(3))
    jout, _ = jc(jmx.nd.array(x), jc.begin_state(3))
    _assert_same(pout, jout)


def test_sequential_stack_matches_jax():
    def make(pkg):
        stack = pkg.SequentialRNNCell(prefix="s_")
        with stack.name_scope():
            stack.add(pkg.LSTMCell(8, input_size=4))
            stack.add(pkg.LSTMCell(6, input_size=8))
        return stack

    ps, js = _pair(lambda: make(rnn), lambda: make(jrnn))
    assert sorted(ps.collect_params()) == sorted(js.collect_params())
    x = _rand(2, 4)
    pst, jst = ps.begin_state(2), js.begin_state(2)
    assert len(pst) == 4
    pout, pnew = ps(mx.nd.array(x), pst)
    jout, jnew = js(jmx.nd.array(x), jst)
    assert pout.shape == (2, 6)
    _assert_same([pout] + pnew, [jout] + jnew)


def test_residual_cell_matches_jax():
    pc, jc = _pair(
        lambda: rnn.ResidualCell(rnn.GRUCell(4, input_size=4, prefix="g_")),
        lambda: jrnn.ResidualCell(jrnn.GRUCell(4, input_size=4,
                                               prefix="g_")))
    x = _rand(2, 4)
    pout, pst = pc(mx.nd.array(x), pc.begin_state(2))
    jout, jst = jc(jmx.nd.array(x), jc.begin_state(2))
    _assert_same([pout] + pst, [jout] + jst)


def test_dropout_cell():
    """Identity in inference (both packages) and at rate 0; in training
    the port keeps about 1 - rate of the elements, scaled by 1 / (1 -
    rate), and ``mx.random.seed`` repeats the mask."""
    x = _rand(64, 32)
    for pkg, nd in ((rnn, mx.nd), (jrnn, jmx.nd)):
        out, states = pkg.DropoutCell(0.5)(nd.array(x), [])
        np.testing.assert_array_equal(out.asnumpy(), x)
        assert states == []
    with ag.record():
        np.testing.assert_array_equal(
            rnn.DropoutCell(0.0)(mx.nd.array(x), [])[0].asnumpy(), x)
        mx.random.seed(3)
        a = rnn.DropoutCell(0.5)(mx.nd.array(x), [])[0].asnumpy()
        mx.random.seed(3)
        b = rnn.DropoutCell(0.5)(mx.nd.array(x), [])[0].asnumpy()
    np.testing.assert_array_equal(a, b)
    kept = a != 0
    assert 0.4 < kept.mean() < 0.6
    np.testing.assert_allclose(a[kept], 2 * x[kept], rtol=1e-6)


def test_zoneout_cell():
    """At rate 0 in training, and in inference, the base cell's step (as
    the JAX cell's); at 0.5 each output and state element is the new
    value or the previous one, repeatably after ``mx.random.seed``."""
    def make(pkg, po, ps):
        return pkg.ZoneoutCell(pkg.LSTMCell(6, input_size=3, prefix="l_"),
                               zoneout_outputs=po, zoneout_states=ps)

    x = _rand(2, 3)
    for rates in ((0.0, 0.0), (0.5, 0.5)):
        pc, jc = _pair(lambda: make(rnn, *rates), lambda: make(jrnn, *rates))
        pout, pst = pc(mx.nd.array(x), pc.begin_state(2))
        jout, jst = jc(jmx.nd.array(x), jc.begin_state(2))
        _assert_same([pout] + pst, [jout] + jst)       # inference
    pc, jc = _pair(lambda: make(rnn, 0.0, 0.0), lambda: make(jrnn, 0.0, 0.0))
    with ag.record():
        pout, pst = pc(mx.nd.array(x), pc.begin_state(2))
    with jag.record():
        jout, jst = jc(jmx.nd.array(x), jc.begin_state(2))
    _assert_same([pout] + pst, [jout] + jst)
    cell = make(rnn, 0.5, 0.5)
    cell.initialize()
    base = cell.base_cell
    prev = [mx.nd.array(_rand(2, 6, seed=s)) for s in (5, 6)]
    new_out, new_states = base(mx.nd.array(x), prev)
    runs = []
    for _ in range(2):
        mx.random.seed(9)
        cell.reset()
        with ag.record():
            runs.append(cell(mx.nd.array(x), prev))
    out, states = runs[0]
    np.testing.assert_array_equal(out.asnumpy(), runs[1][0].asnumpy())
    o = out.asnumpy()
    assert np.all((o == new_out.asnumpy()) | (o == 0))
    for s, n, p in zip(states, new_states, prev):
        s = s.asnumpy()
        assert np.all((s == n.asnumpy()) | (s == p.asnumpy()))


def test_bidirectional_unroll_matches_jax():
    def make(pkg):
        return pkg.BidirectionalCell(
            pkg.LSTMCell(6, input_size=4, prefix="l_"),
            pkg.LSTMCell(6, input_size=4, prefix="r_"))

    pb, jb = _pair(lambda: make(rnn), lambda: make(jrnn))
    x = _rand(2, 3, 4)
    pout, pst = pb.unroll(3, mx.nd.array(x), merge_outputs=True)
    jout, jst = jb.unroll(3, jmx.nd.array(x), merge_outputs=True)
    assert pout.shape == (2, 3, 12)
    _assert_same([pout] + pst, [jout] + jst)


@pytest.mark.parametrize("name,kw,n_states", [
    ("RNN", {"activation": "relu"}, 1), ("RNN", {"activation": "tanh"}, 1),
    ("LSTM", {}, 2), ("GRU", {}, 1)])
def test_fused_layers_match_jax(name, kw, n_states):
    pl, jl = _pair(lambda: getattr(rnn, name)(16, num_layers=2, input_size=8,
                                              prefix="f_", **kw),
                   lambda: getattr(jrnn, name)(16, num_layers=2, input_size=8,
                                               prefix="f_", **kw))
    x = _rand(5, 3, 8)
    pout = pl(mx.nd.array(x))
    jout = jl(jmx.nd.array(x))
    assert pout.shape == (5, 3, 16)
    _assert_same(pout, jout)
    st = [_rand(2, 3, 16, seed=i + 1) for i in range(n_states)]
    pout, pst = pl(mx.nd.array(x), [mx.nd.array(s) for s in st])
    jout, jst = jl(jmx.nd.array(x), [jmx.nd.array(s) for s in st])
    assert len(pst) == n_states and pst[0].shape == (2, 3, 16)
    _assert_same([pout] + pst, [jout] + jst)


def test_fused_ntc_bidirectional_matches_jax():
    pl, jl = _pair(lambda: rnn.LSTM(8, layout="NTC", bidirectional=True,
                                    input_size=4, prefix="b_"),
                   lambda: jrnn.LSTM(8, layout="NTC", bidirectional=True,
                                     input_size=4, prefix="b_"))
    x = _rand(2, 6, 4)
    pout = pl(mx.nd.array(x))
    assert pout.shape == (2, 6, 16)
    _assert_same(pout, jl(jmx.nd.array(x)))


def test_fused_deferred_input_size_matches_jax():
    x = _rand(5, 3, 7)
    pl, jl = _pair(lambda: rnn.GRU(6, num_layers=2, prefix="d_"),
                   lambda: jrnn.GRU(6, num_layers=2, prefix="d_"), x)
    assert pl.l0_i2h_weight.shape == (18, 7)
    _assert_same(pl(mx.nd.array(x)), jl(jmx.nd.array(x)))


def test_fused_lstm_matches_cell_unroll():
    """tests/test_gluon_rnn.py:97: the fused layer against an unrolled
    LSTMCell with its weights, in the port and against JAX."""
    layer = rnn.LSTM(5, input_size=3, prefix="l_")
    layer.initialize()
    cell = rnn.LSTMCell(5, input_size=3, prefix="c_")
    cell.initialize()
    for k in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"):
        getattr(cell, k).set_data(getattr(layer, f"l0_{k}").data())
    x = mx.nd.array(_rand(4, 2, 3))
    fused = layer(x)
    unrolled, _ = cell.unroll(4, x, layout="TNC", merge_outputs=True)
    _assert_same(fused, unrolled)


def test_gradients_match_jax():
    pl, jl = _pair(lambda: rnn.GRU(8, num_layers=2, input_size=4,
                                   prefix="g_"),
                   lambda: jrnn.GRU(8, num_layers=2, input_size=4,
                                    prefix="g_"))
    x = _rand(5, 2, 4)
    px, jx = mx.nd.array(x), jmx.nd.array(x)
    px.attach_grad()
    jx.attach_grad()
    with ag.record():
        out = pl(px)
        (out * out).sum().backward()
    with jag.record():
        jout = jl(jx)
        (jout * jout).sum().backward()
    pairs = [(px.grad, jx.grad)] + [
        (p.grad(), jl._collect_params_with_structure()[n].grad())
        for n, p in pl._collect_params_with_structure().items()]
    for got, want in pairs:
        got, want = got.asnumpy(), want.asnumpy()
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= RTOL * max(1.0, np.abs(
            want).max())


def _sum_task(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(8, 16, 2).astype(np.float32)            # TNC
    return x, x.sum(axis=(0, 2))[:, None].astype(np.float32)


def test_training_steps_match_jax_and_converge():
    """tests/test_gluon_rnn.py:137's task (predict the sum of a sequence
    with an LSTM and a Dense head, "adam" lr 0.01): 3 steps from the
    same weights match the JAX package's losses and weights; 30 steps of
    the port halve the loss."""
    from mxnet_tpu.gluon import Trainer as JTrainer, loss as jloss
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import Trainer, loss as gloss, nn as gnn

    def make(pkg, nn):
        seq = nn.HybridSequential(prefix="m_")
        with seq.name_scope():
            seq.add(pkg.LSTM(16, input_size=2))
            seq.add(nn.Dense(1, in_units=16))
        return seq

    pm, jm = _pair(lambda: make(rnn, gnn), lambda: make(jrnn, jnn))
    pt = Trainer(pm.collect_params(), "adam", {"learning_rate": 0.01})
    jt = JTrainer(jm.collect_params(), "adam", {"learning_rate": 0.01})
    x, y = _sum_task()
    losses = {"port": [], "jax": []}
    for step in range(30):
        with ag.record():
            seq = pm[0](mx.nd.array(x))
            loss = gloss.L2Loss()(pm[1](seq.slice_axis(0, 7, 8).squeeze(0)),
                                  mx.nd.array(y))
        loss.backward()
        pt.step(16)
        losses["port"].append(float(loss.mean().asscalar()))
        if step < 3:
            with jag.record():
                jseq = jm[0](jmx.nd.array(x))
                jl = jloss.L2Loss()(jm[1](jseq.slice_axis(0, 7, 8).squeeze(
                    0)), jmx.nd.array(y))
            jl.backward()
            jt.step(16)
            losses["jax"].append(float(jl.mean().asscalar()))
        if step == 2:
            want = _jax_values(jm)
            for name, got in export_params(pm).items():
                np.testing.assert_allclose(got, want[name], rtol=1e-4,
                                           atol=1e-5)
    np.testing.assert_allclose(losses["port"][:3], losses["jax"],
                               rtol=1e-5)
    assert losses["port"][-1] < 0.5 * losses["port"][0]


def test_hybridized_matches_unhybridized():
    """A hybridized LSTM (its ``cachedop`` pair; a plain call on the
    CPU) gives the unhybridized outputs, states and gradients."""
    results = []
    for hybrid in (False, True):
        layer = rnn.LSTM(8, num_layers=2, input_size=4, prefix="h_")
        layer.initialize(mx.init.Xavier(),
                         generator=torch.Generator().manual_seed(0))
        if hybrid:
            layer.hybridize()
        x = mx.nd.array(_rand(5, 3, 4))
        st = [mx.nd.array(_rand(2, 3, 8, seed=s)) for s in (1, 2)]
        for _ in range(2):
            with ag.record():
                out, states = layer(x, st)
                (out.sum() + states[1].sum()).backward()
        results.append([out.asnumpy()] + [s.asnumpy() for s in states] +
                       [p.grad().asnumpy()
                        for p in layer.collect_params().values()])
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)


def test_parameter_names_match_jax():
    def blocks(pkg):
        stack = pkg.SequentialRNNCell(prefix="s_")
        with stack.name_scope():
            stack.add(pkg.GRUCell(4, input_size=3))
            stack.add(pkg.ResidualCell(pkg.RNNCell(4, input_size=4)))
        return [pkg.LSTM(8, num_layers=2, bidirectional=True, input_size=4,
                         prefix="lstm_"),
                pkg.GRU(8, prefix="gru_"), pkg.RNN(8, prefix="rnn_"),
                pkg.LSTMCell(8, prefix="cell_"), stack]

    for pb, jb in zip(blocks(rnn), blocks(jrnn)):
        assert list(pb.collect_params()) == list(jb.collect_params())
        assert list(pb._collect_params_with_structure()) == \
            list(jb._collect_params_with_structure())
        for name, p in pb.collect_params().items():
            assert p.shape == tuple(jb.collect_params()[name].shape)
    assert "lstm_r1_h2h_bias" in blocks(rnn)[0].collect_params()


def test_params_files_cross_both_ways(tmp_path):
    pl, jl = _pair(lambda: rnn.LSTM(8, num_layers=2, bidirectional=True,
                                    input_size=4, prefix="x_"),
                   lambda: jrnn.LSTM(8, num_layers=2, bidirectional=True,
                                     input_size=4, prefix="x_"))
    jl.collect_params().save(str(tmp_path / "jax.params"))
    fresh = rnn.LSTM(8, num_layers=2, bidirectional=True, input_size=4,
                     prefix="x_")
    fresh.initialize()
    fresh.collect_params().load(str(tmp_path / "jax.params"))
    x = _rand(3, 2, 4)
    _assert_same(fresh(mx.nd.array(x)), jl(jmx.nd.array(x)))

    trained = {n: p.data() * 1.5 for n, p in pl.collect_params().items()}
    mx.nd.save(str(tmp_path / "port.params"), trained)
    jfresh = jrnn.LSTM(8, num_layers=2, bidirectional=True, input_size=4,
                       prefix="x_")
    jfresh.initialize()
    jfresh.collect_params().load(str(tmp_path / "port.params"))
    for name, p in jfresh.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      trained[name].asnumpy())


def test_layer_dropout_acts_in_training_only():
    """C12 at the layer: ``rnn.LSTM(dropout=0.5, num_layers=2)`` in
    training differs from the same layer without dropout in the port
    (and not in the JAX package, whose op drops ``p``); in inference
    the two agree."""
    def make(pkg, rate):
        return pkg.LSTM(8, num_layers=2, dropout=rate, input_size=4,
                        prefix="d_")

    pl, jl = _pair(lambda: make(rnn, 0.5), lambda: make(jrnn, 0.5))
    ref, jref = _pair(lambda: make(rnn, 0.0), lambda: make(jrnn, 0.0))
    load_jax_params(ref, _jax_values(jl))
    x = _rand(5, 3, 4)
    with ag.record():
        dropped = pl(mx.nd.array(x)).asnumpy()
        plain = ref(mx.nd.array(x)).asnumpy()
    with jag.record():
        jdropped = jl(jmx.nd.array(x)).asnumpy()
    assert np.abs(dropped - plain).max() > 1e-3
    np.testing.assert_allclose(jdropped, plain, rtol=RTOL, atol=ATOL)
    _assert_same(pl(mx.nd.array(x)), jl(jmx.nd.array(x)))
