"""``examples/gluon/word_lm.py``'s model and loop (``chip_smoke.
word_lm_model``, ``word_lm_step``: the example's code over package
``mx``) in the port against the JAX package on the CPU, at a small width
(vocab 50, 16 units, 2 LSTM layers, bptt 5, batch 4, dropout 0), tied
and untied: three steps of the loop from the same weights give the same
losses, clip totals and parameters (``RTOL``/``ATOL``; ``PARAM_TOL``
after three SGD steps at lr 1), the state carried from step to step
through ``detach``; hybridized and not give the same steps.

Fault C13 (ROADMAP.md): the JAX ``ParameterDict.get`` refuses the
example's tied decoder (``nn.Dense(vocab, flatten=False,
params=self.encoder.params)`` asks for ``(vocab, 0)`` where the
embedding holds ``(vocab, 16)``); MXNet 1.x's ``get`` merges the two
shapes, and so does the port's. The JAX side of the tied case is the
same model with ``in_units=embed_dim`` on the decoder, as MXNet's own
word-language-model example writes it."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import batchify, detach, word_lm_model, word_lm_step
from mxnet_tpu_torch.convert import export_params, load_jax_params

RTOL = ATOL = 1e-5
PARAM_TOL = 1e-4
CFG = {"vocab_size": 50, "embed_dim": 16, "hidden": 16, "layers": 2,
       "bptt": 5, "batch_size": 4, "lr": 1.0, "clip": 0.25}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def _jax_tied(v, e, h, layers):
    """The example's RNNModel in the JAX package with the decoder of
    MXNet's word-language-model example (``in_units`` given)."""
    gluon, nn, rnn = jmx.gluon, jmx.gluon.nn, jmx.gluon.rnn

    class RNNModel(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = nn.Dropout(0.0)
                self.encoder = nn.Embedding(v, e)
                self.rnn = rnn.LSTM(h, num_layers=layers, dropout=0.0,
                                    input_size=e)
                self.decoder = nn.Dense(v, flatten=False, in_units=e,
                                        params=self.encoder.params)

        def hybrid_forward(self, F, inputs, state):
            emb = self.drop(self.encoder(inputs))
            out, state = self.rnn(emb, state)
            out = self.drop(out)
            return self.decoder(out), state

        def begin_state(self, batch_size, ctx):
            return self.rnn.begin_state(batch_size=batch_size, ctx=ctx)

    return RNNModel(prefix="lm_")


def _data(steps=3, seed=0):
    rng = np.random.RandomState(seed)
    ids = list(rng.randint(0, CFG["vocab_size"],
                           CFG["batch_size"] * (steps * CFG["bptt"] + 2)))
    return batchify(ids, CFG["batch_size"])


def _models(tied, hybridize=False):
    c = CFG
    args = (c["vocab_size"], c["embed_dim"], c["hidden"], c["layers"])
    jmx.random.seed(0)
    jm = _jax_tied(*args) if tied else \
        word_lm_model(jmx)(*args, dropout=0.0, prefix="lm_")
    jm.initialize(jmx.init.Xavier())
    jm(jmx.nd.zeros((c["bptt"], c["batch_size"])),
       jm.begin_state(c["batch_size"], jmx.cpu()))
    pm = word_lm_model(mx)(*args, dropout=0.0, tie_weights=tied,
                           prefix="lm_")
    pm.initialize()
    load_jax_params(pm, {n: p.data().asnumpy() for n, p in
                         jm._collect_params_with_structure().items()})
    if hybridize:
        pm.hybridize()
    return pm, jm


def _steps(pkg, model, data, steps=3):
    ctx = pkg.cpu()
    trainer = pkg.gluon.Trainer(model.collect_params(), "sgd",
                                {"learning_rate": CFG["lr"]})
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    state = model.begin_state(CFG["batch_size"], ctx)
    out = []
    for k in range(steps):
        i = k * CFG["bptt"]
        x = pkg.nd.array(data[i:i + CFG["bptt"]], ctx=ctx)
        y = pkg.nd.array(data[i + 1:i + 1 + CFG["bptt"]], ctx=ctx)
        state, nll, total, _ = word_lm_step(
            pkg, model, trainer, loss_fn, CFG, CFG["vocab_size"], x, y,
            state, ctx)
        out.append((nll, total))
    return out, state


@pytest.mark.parametrize("tied", [False, True])
def test_three_steps_match_jax(tied):
    pm, jm = _models(tied)
    data = _data()
    got, state = _steps(mx, pm, data)
    want, _ = _steps(jmx, jm, data)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=RTOL,
                               atol=ATOL)
    assert all(np.isfinite(nll) and total > 0 for nll, total in got)
    jvals = {n: p.data().asnumpy() for n, p in
             jm._collect_params_with_structure().items()}
    for name, value in export_params(pm).items():
        np.testing.assert_allclose(value, jvals[name], rtol=PARAM_TOL,
                                   atol=PARAM_TOL)
    assert all(s._data.grad_fn is None for s in detach(state))


@pytest.mark.parametrize("tied", [False, True])
def test_hybridized_steps_match_unhybridized(tied):
    """The loop with ``hybridize()`` (the ``cachedop`` pair; a plain
    call on the CPU) and without, the state carried through
    ``detach``: the same losses, clip totals and weights."""
    data = _data(4)
    runs = []
    for hybrid in (False, True):
        pm, _ = _models(tied, hybridize=hybrid)
        got, _ = _steps(mx, pm, data, steps=4)
        runs.append((got, export_params(pm)))
    assert runs[0][0] == runs[1][0]
    for name, value in runs[0][1].items():
        np.testing.assert_array_equal(value, runs[1][1][name])


def test_c13_the_tied_decoder_shares_the_embedding():
    """C13: the example's tied decoder builds in the port and shares the
    embedding's Parameter (one gradient buffer summing both uses); the
    JAX package refuses it."""
    c = CFG
    args = (c["vocab_size"], c["embed_dim"], c["hidden"], c["layers"])
    with pytest.raises(AssertionError, match="incompatible"):
        word_lm_model(jmx)(*args, tie_weights=True)
    pm = word_lm_model(mx)(*args, tie_weights=True)
    assert pm.decoder.weight is pm.encoder.weight
    assert pm.decoder.weight.shape == (c["vocab_size"], c["embed_dim"])
    names = list(pm.collect_params())
    assert len(names) == len(set(names)) == 10
