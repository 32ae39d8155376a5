"""The port's fused ``RNN`` op (``mxnet_tpu_torch/ops/nn.py``) and its
symbol support against the JAX package's on the CPU.

* The op against the JAX ``_rnn`` (``mxnet_tpu/ops/nn.py:518``) over
  every mode, 1 and 2 layers, one and two directions, random and zero
  initial states and LSTM state clipping: outputs, ``hn`` and ``cn``
  within ``RTOL``/``ATOL``; gradients of one seeded loss against
  ``jax.grad`` within ``RTOL`` of each gradient's largest value.
* The card route's code on the CPU: ``rnn_run("cudnn", ...)`` hands the
  views of the flat vector to ``torch._VF``, whose CPU implementation
  has cuDNN's semantics; it equals the per-step form, which pins the
  weight list's order and the gate orders (LSTM ``i, f, g, o``, GRU
  ``r, z, n``).
* ``mx.sym.RNN``: ``<name>_params``, its flat length from
  ``infer_shape`` against the JAX package's ``_rnn_param_size``, and
  ``train_ptb.py``'s ``sym_gen`` in JSON both ways (the same outputs
  from either package's loaded graph).
* Fault C12 (ROADMAP.md): the JAX op ignores ``p``; the port drops
  between layers in training as MXNet 1.x does, with the masks of its
  plain version, and agrees with JAX at ``p = 0`` or outside training.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import sym_gen_factory
from mxnet_tpu.ops.nn import _rnn as jax_rnn
from mxnet_tpu.symbol.symbol import _rnn_param_size
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn as nn_ops

RTOL = ATOL = 1e-5   # float32, the same per-step arithmetic in both
MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]
T, B, I, H = 5, 3, 4, 6


def _inputs(mode, layers, bidirectional, seed=0, zero_state=False):
    rng = np.random.RandomState(seed)
    ndir = 2 if bidirectional else 1
    n = nn_ops.rnn_param_size(I, H, layers, mode, bidirectional)
    state = (np.zeros if zero_state else
             lambda s: rng.randn(*s))((layers * ndir, B, H))
    cell = (np.zeros if zero_state else
            lambda s: rng.randn(*s))((layers * ndir, B, H))
    return [a.astype(np.float32) for a in (
        rng.randn(T, B, I), rng.randn(n) * 0.3, state, cell,
        rng.randn(T, B, H * ndir), rng.randn(layers * ndir, B, H),
        rng.randn(layers * ndir, B, H))]


def _close_per_tensor(got, want):
    scale = RTOL * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= scale


CASES = [(m, layers, bi, False, None) for m in MODES for layers in (1, 2)
         for bi in (False, True)] + \
    [(m, 2, False, True, None) for m in ("lstm", "gru")] + \
    [("lstm", layers, False, False, (-0.2, 0.3)) for layers in (1, 2)]


@pytest.mark.parametrize("mode,layers,bi,zero_state,clip", CASES)
def test_rnn_op_matches_jax(mode, layers, bi, zero_state, clip):
    x, p, h, c, wo, wh, wc = _inputs(mode, layers, bi, zero_state=zero_state)
    lstm = mode == "lstm"
    kw = dict(state_size=H, num_layers=layers, mode=mode, bidirectional=bi)
    if clip:
        kw.update(lstm_state_clip_min=clip[0], lstm_state_clip_max=clip[1])

    def jloss(x, p, h, c):
        out, hn, cn = jax_rnn(x, p, h, c if lstm else None, **kw)
        return (out * wo).sum() + (hn * wh).sum() + (cn * wc).sum()

    jouts = jax_rnn(*[jnp.asarray(a) for a in (x, p, h)],
                    jnp.asarray(c) if lstm else None, **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in (x, p, h, c)])
    ts = [torch.tensor(a, requires_grad=True) for a in (x, p, h, c)]
    outs = nn_ops._rnn(*ts[:3], ts[3] if lstm else None, **kw)
    for got, want in zip(outs, jouts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)
    loss = sum((o * torch.tensor(w)).sum() for o, w in zip(outs,
                                                            (wo, wh, wc)))
    grads = torch.autograd.grad(loss, ts if lstm else ts[:3])
    for got, want in zip(grads, jgrads):
        _close_per_tensor(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", MODES)
def test_the_cudnn_route_code_matches_the_per_step_form(mode):
    """The views ``rnn_weights`` hands to ``torch._VF`` (cuDNN's weight
    list order) give torch's own RNN of the per-step form's result."""
    for layers, bi in ((1, False), (2, False), (2, True)):
        x, p, h, c, *_ = [torch.tensor(a) for a in _inputs(mode, layers,
                                                           bi)]
        c = c if mode == "lstm" else None
        for got, want in zip(
                nn_ops.rnn_run("cudnn", x, p, h, c, H, layers, mode, bi),
                nn_ops.rnn_run("plain", x, p, h, c, H, layers, mode, bi)):
            if want is not None:
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_rnn_param_size_and_views():
    for mode in MODES:
        for layers, bi in ((1, False), (3, True)):
            assert nn_ops.rnn_param_size(I, H, layers, mode, bi) == \
                _rnn_param_size((T, B, I), {
                    "mode": mode, "state_size": H, "num_layers": layers,
                    "bidirectional": bi})
    p = torch.arange(float(nn_ops.rnn_param_size(I, H, 2, "gru", True)))
    views = nn_ops.rnn_weights(p, "gru", 2, 2, I, H)
    assert [tuple(v.shape) for v in views[2]] == [(3 * H, 2 * H),
                                                  (3 * H, H), (3 * H,),
                                                  (3 * H,)]
    assert all(v.data_ptr() >= p.data_ptr() for w in views for v in w)
    assert float(views[0][0][0, 0]) == 0.0       # weights first
    with pytest.raises(MXNetError, match="parameter vector"):
        nn_ops.rnn_weights(p[1:], "gru", 2, 2, I, H)


def test_unported_arguments_raise_naming_them():
    x, p, h, c, *_ = [torch.tensor(a) for a in _inputs("lstm", 1, False)]
    for kw, name in (({"projection_size": 4}, "projection_size"),
                     ({"use_sequence_length": True}, "use_sequence_length")):
        with pytest.raises(MXNetError, match=name):
            nn_ops._rnn(x, p, h, c, state_size=H, **kw)
    with pytest.raises(MXNetError, match="state_cell"):
        nn_ops._rnn(x, p, h, state_size=H)


# --------------------------------------------------------------- C12 ---

def _manual_dropped(x, p, h, c, rate, seed, mode="lstm"):
    """Two one-layer op calls with the mask drawn between them from a
    generator seeded ``seed``, as MXNet 1.x drops between layers."""
    ws = nn_ops.rnn_weights(p, mode, 2, 1, I, H)
    flat = [torch.cat([w.reshape(-1) for w in ws[i][:2]] +
                      [b.reshape(-1) for b in ws[i][2:]]) for i in (0, 1)]
    gen = torch.Generator().manual_seed(seed)
    out0, h0, c0 = nn_ops._rnn(x, flat[0], h[:1], c[:1], state_size=H)
    keep = torch.rand(out0.shape, generator=gen) < 1 - rate
    mid = torch.where(keep, out0 / (1 - rate), torch.zeros(()))
    out1, h1, c1 = nn_ops._rnn(mid, flat[1], h[1:], c[1:], state_size=H)
    return out1, torch.cat([h0, h1]), torch.cat([c0, c1])


def test_c12_dropout_between_layers_in_training():
    """C12: in training with ``p > 0`` the port drops between layers and
    the JAX op does not: the packages differ, and the port's output is
    the two layers with the mask of its plain version between them."""
    x, p, h, c, *_ = _inputs("lstm", 2, False)
    kw = dict(state_size=H, num_layers=2, mode="lstm", p=0.5)
    got = nn_ops._rnn(*[torch.tensor(a) for a in (x, p, h, c)],
                      training=True,
                      generator=torch.Generator().manual_seed(3), **kw)
    want = _manual_dropped(*[torch.tensor(a) for a in (x, p, h, c)],
                           0.5, 3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    jout = np.asarray(jax_rnn(*[jnp.asarray(a) for a in (x, p, h, c)],
                              **kw)[0])
    assert np.abs(got[0].numpy() - jout).max() > 100 * ATOL


@pytest.mark.parametrize("rate,training", [(0.5, False), (0.0, True)])
def test_c12_no_dropout_agrees_with_jax(rate, training):
    x, p, h, c, *_ = _inputs("lstm", 2, False)
    kw = dict(state_size=H, num_layers=2, mode="lstm", p=rate)
    got = nn_ops._rnn(*[torch.tensor(a) for a in (x, p, h, c)],
                      training=training, **kw)
    want = jax_rnn(*[jnp.asarray(a) for a in (x, p, h, c)], **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_dropout_draws_from_mx_random_by_default():
    x, p, h, c, *_ = [torch.tensor(a) for a in _inputs("lstm", 2, False)]
    kw = dict(state_size=H, num_layers=2, p=0.5, training=True)
    mx.random.seed(11)
    a = nn_ops._rnn(x, p, h, c, **kw)[0]
    b = nn_ops._rnn(x, p, h, c, **kw)[0]
    mx.random.seed(11)
    a2 = nn_ops._rnn(x, p, h, c, **kw)[0]
    assert torch.equal(a, a2) and not torch.equal(a, b)


# ------------------------------------------------------------- symbol ---

def _ptb_symbols(bucket=10):
    port = sym_gen_factory(mx, 50, 8, 16, 4)(bucket)[0]
    jsym = sym_gen_factory(jmx, 50, 8, 16, 4)(bucket)[0]
    return port, jsym


def test_rnn_symbol_arguments_and_shapes():
    port, jsym = _ptb_symbols()
    assert port.list_arguments() == jsym.list_arguments()
    assert "lstm_params" in port.list_arguments()
    assert port.list_outputs() == jsym.list_outputs()
    shapes = dict(data=(4, 9), softmax_label=(4, 9))
    pa, po, _ = port.infer_shape(**shapes)
    ja, jo, _ = jsym.infer_shape(**shapes)
    assert [tuple(s) for s in pa] == [tuple(s) for s in ja]
    assert [tuple(s) for s in po] == [tuple(s) for s in jo]
    n = dict(zip(port.list_arguments(), pa))["lstm_params"]
    assert n == (_rnn_param_size((9, 4, 8), {"state_size": 16}),)


def _feeds(sym, seed=0):
    rng = np.random.RandomState(seed)
    args, _, _ = sym.infer_shape(data=(4, 9), softmax_label=(4, 9))
    feed = {}
    for name, shape in zip(sym.list_arguments(), args):
        if name in ("data", "softmax_label"):
            feed[name] = rng.randint(0, 50, shape).astype(np.float32)
        else:
            feed[name] = (rng.randn(*shape) * 0.2).astype(np.float32)
    return feed


def test_rnn_symbol_json_both_ways():
    """Each package's ``sym_gen`` graph, written to JSON and loaded by
    the other, gives the same output as the writer's own graph."""
    port, jsym = _ptb_symbols()
    feed = _feeds(port)
    with mx.cpu():
        want_port = port.eval_with({k: mx.nd.array(v) for k, v in
                                    feed.items()}).asnumpy()
        from_jax = mx.sym.load_json(jsym.tojson())
        got_port = from_jax.eval_with({k: mx.nd.array(v) for k, v in
                                       feed.items()}).asnumpy()
    from_port = jmx.sym.load_json(port.tojson())
    assert from_port.list_arguments() == jsym.list_arguments()
    got_jax = np.asarray(from_port.eval_with(
        {k: jmx.nd.array(v) for k, v in feed.items()}).asnumpy())
    want_jax = np.asarray(jsym.eval_with(
        {k: jmx.nd.array(v) for k, v in feed.items()}).asnumpy())
    np.testing.assert_allclose(got_port, want_port, rtol=0, atol=0)
    np.testing.assert_allclose(got_jax, want_jax, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(want_port, want_jax, rtol=RTOL, atol=ATOL)


def test_rnn_symbol_simple_bind_allocates_the_flat_vector():
    port, _ = _ptb_symbols(20)
    with mx.cpu():
        ex = port.simple_bind(mx.cpu(), data=(4, 19),
                              softmax_label=(4, 19))
    assert ex.arg_dict["lstm_params"].shape == (
        nn_ops.rnn_param_size(8, 16),)
    assert ex.arg_dict["lstm_init_state"].shape == (1, 4, 16)
