"""The port's ``BucketingModule`` and ``Module.bind(shared_module=)``
against the JAX package's on the CPU, over ``tests/test_module.py``'s
pooled ``sym_gen`` and ``examples/rnn/train_ptb.py``'s LSTM ``sym_gen``
(``chip_smoke.sym_gen_factory``) at a small width (vocab 50, 16 units,
batch 4, buckets 5 and 10), with batches that switch buckets.

The port follows MXNet 1.x where the JAX module does not (ROADMAP.md
C14): one optimizer, updater and set of states serves every bucket
(``borrow_optimizer``); the JAX module gives each bucket its own. The
Adam parity cases make the JAX buckets share the default bucket's
updater after each switch (``_borrow``, what MXNet 1.x does), and
C14 is asserted on its own. Both packages get ``rescale_grad`` and no
kvstore (ROADMAP.md C8). Tolerances: outputs and the metric within
``RTOL``/``ATOL``; parameters after 6 Adam updates within ``PARAM_TOL``
(Adam divides by the root of a small second moment)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from chip_smoke import sym_gen_factory
from mxnet_tpu.io.io import DataBatch as JBatch, DataDesc as JDesc
from mxnet_tpu_torch.base import MXNetError

RTOL = ATOL = 1e-5
PARAM_TOL = 1e-4
VOCAB, BATCH = 50, 4


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def pooled_sym_gen(pkg):
    """tests/test_module.py:116-124, with ``sym.mean(embed, axis=1)`` for
    the fluent ``embed.mean(axis=1)`` (the same node; the port's Symbol
    has no fluent methods)."""
    def sym_gen(seq_len):
        data = pkg.sym.var("data")
        embed = pkg.sym.Embedding(data, input_dim=20, output_dim=8,
                                  name="embed")
        pooled = pkg.sym.mean(embed, axis=1)
        fc = pkg.sym.FullyConnected(pooled, num_hidden=2, name="fc")
        sm = pkg.sym.SoftmaxOutput(fc, pkg.sym.var("softmax_label"),
                                   name="softmax")
        return sm, ("data",), ("softmax_label",)
    return sym_gen


def _batches(keys, lm, seed=0):
    """Per bucket key ``(data, label)`` numpy pairs: next-token labels
    for the LM, the pooled task's class labels otherwise."""
    rng = np.random.RandomState(seed)
    out = []
    for key in keys:
        if lm:
            seq = rng.randint(1, VOCAB, (BATCH, key)).astype(np.float32)
            out.append((key, seq[:, :-1], seq[:, 1:]))
        else:
            x = rng.randint(0, 20, (BATCH, key)).astype(np.float32)
            out.append((key, x, (x.sum(axis=1) % 2).astype(np.float32)))
    return out


def _batch(pkg, key, x, y, lm):
    data = pkg.nd.array(x)
    label = pkg.nd.array(y)
    desc = (JDesc if pkg is jmx else mx.io.DataDesc)
    kw = dict(data=[data], label=[label], pad=0, index=None,
              provide_data=[desc("data", x.shape)],
              provide_label=[desc("softmax_label", y.shape)])
    batch = (JBatch if pkg is jmx else mx.io.DataBatch)(**kw)
    batch.bucket_key = key if lm else x.shape[1]
    return batch


def _borrow(jmod):
    """MXNet 1.x's ``borrow_optimizer`` on the JAX buckets."""
    default = jmod._buckets[jmod._default_bucket_key]
    for mod in jmod._buckets.values():
        mod._optimizer, mod._updater = default._optimizer, default._updater


def _modules(sym_gen_of, default_key, shapes, optimizer, opt_params,
             seed=0):
    port = mx.mod.BucketingModule(sym_gen_of(mx), default_bucket_key=
                                  default_key, context=mx.cpu())
    jax = jmx.mod.BucketingModule(sym_gen_of(jmx),
                                  default_bucket_key=default_key)
    port.bind(*shapes)
    jax.bind([JDesc(*d) for d in shapes[0]],
             [JDesc(*d) for d in shapes[1]])
    jax.init_params(jmx.init.Uniform(0.1))
    arg, aux = jax.get_params()
    port.init_params(arg_params={k: mx.nd.array(v.asnumpy())
                                 for k, v in arg.items()},
                     aux_params={k: mx.nd.array(v.asnumpy())
                                 for k, v in aux.items()})
    for m in (port, jax):
        m.init_optimizer(kvstore=None, optimizer=optimizer,
                         optimizer_params=opt_params)
    return port, jax


def _run(port, jax, batches, lm, borrow, metrics=()):
    for key, x, y in batches:
        for m, pkg in ((port, mx), (jax, jmx)):
            b = _batch(pkg, key, x, y, lm)
            m.forward(b, is_train=True)
            if m is jax and borrow:
                _borrow(jax)
            m.backward()
            m.update()
        po, jo = port.get_outputs()[0], jax.get_outputs()[0]
        np.testing.assert_allclose(po.asnumpy(), jo.asnumpy(), rtol=RTOL,
                                   atol=ATOL)
        for pm, jm in metrics:
            pm.update([mx.nd.array(y)], [po])
            jm.update([jmx.nd.array(y)], [jo])


def _assert_params(port, jax, tol):
    parg, paux = port.get_params()
    jarg, jaux = jax.get_params()
    assert sorted(parg) == sorted(jarg)
    for name in parg:
        np.testing.assert_allclose(parg[name].asnumpy(),
                                   jarg[name].asnumpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("optimizer,params", [
    ("sgd", {"learning_rate": 0.1, "rescale_grad": 0.25}),
    ("adam", {"learning_rate": 0.01, "rescale_grad": 0.25})])
def test_pooled_buckets_match_jax(optimizer, params):
    port, jax = _modules(pooled_sym_gen, 10, ([("data", (BATCH, 10))],
                                              [("softmax_label",
                                                (BATCH,))]),
                         optimizer, params)
    _run(port, jax, _batches([10, 5, 7, 10, 5, 7], lm=False), lm=False,
         borrow=True)
    assert sorted(port._buckets) == [5, 7, 10]
    _assert_params(port, jax, PARAM_TOL)


def _lm_modules(optimizer="adam"):
    def sym_gen_of(pkg):
        return sym_gen_factory(pkg, VOCAB, 8, 16, BATCH)

    shapes = ([("data", (BATCH, 9))], [("softmax_label", (BATCH, 9))])
    return _modules(sym_gen_of, 10, shapes, optimizer,
                    {"learning_rate": 0.01, "rescale_grad": 1.0 / BATCH})


def test_train_ptb_buckets_match_jax():
    """The LSTM ``sym_gen`` over buckets 5 and 10: outputs at every
    batch, the Perplexity metric (with and without ``ignore_label``) and
    the parameters after 6 Adam updates."""
    port, jax = _lm_modules()
    metrics = [(mx.metric.Perplexity(), jmx.metric.Perplexity()),
               (mx.metric.Perplexity(ignore_label=3),
                jmx.metric.Perplexity(ignore_label=3))]
    _run(port, jax, _batches([10, 5, 5, 10, 5, 10], lm=True), lm=True,
         borrow=True, metrics=metrics)
    for pm, jm in metrics:
        (pn, pv), = pm.get_name_value()
        (jn, jv), = jm.get_name_value()
        assert pn == jn
        np.testing.assert_allclose(pv, jv, rtol=RTOL)
    _assert_params(port, jax, PARAM_TOL)
    assert port.symbol.list_arguments() == jax.symbol.list_arguments()


def test_c14_one_updater_serves_every_bucket():
    """C14: the port's buckets share the default bucket's updater (and
    its Adam states); the JAX module's do not."""
    port, jax = _lm_modules()
    batches = _batches([10, 5], lm=True)
    _run(port, jax, batches, lm=True, borrow=False)
    assert port._buckets[5]._updater is port._buckets[10]._updater
    assert jax._buckets[5]._updater is not jax._buckets[10]._updater
    states = port._buckets[10]._updater.states
    assert len(states) == len(port._buckets[10]._param_names)


def test_switch_bucket_shares_storage():
    port, _ = _lm_modules()
    port.switch_bucket(5, [("data", (BATCH, 4))],
                       [("softmax_label", (BATCH, 4))])
    small, big = port._buckets[5], port._buckets[10]
    assert small is port._curr_module
    for name in big._param_names:
        for d in ("arg_dict", "grad_dict"):
            assert getattr(small._exec, d)[name] is \
                getattr(big._exec, d)[name]
    before = small._exec.arg_dict["pred_bias"].asnumpy().copy()
    (key, x, y), = _batches([5], lm=True)
    port.forward(_batch(mx, key, x, y, True), is_train=True)
    port.backward()
    port.update()
    after = big._exec.arg_dict["pred_bias"].asnumpy()
    assert not np.array_equal(before, after)
    assert port.default_bucket_key == 10
    assert port.data_shapes[0].shape == (BATCH, 4)


def test_switch_bucket_before_init_params_raises():
    port = mx.mod.BucketingModule(sym_gen_factory(mx, VOCAB, 8, 16, BATCH),
                                  default_bucket_key=10, context=mx.cpu())
    with pytest.raises(MXNetError, match="bind"):
        port.switch_bucket(5, [("data", (BATCH, 4))])
    port.bind([("data", (BATCH, 9))], [("softmax_label", (BATCH, 9))])
    with pytest.raises(MXNetError, match="initialized parameters"):
        port.switch_bucket(5, [("data", (BATCH, 4))],
                           [("softmax_label", (BATCH, 4))])


def test_a_bucket_bound_late_borrows_the_optimizer():
    port, _ = _lm_modules()
    port.switch_bucket(7, [("data", (BATCH, 6))],
                       [("softmax_label", (BATCH, 6))])
    late = port._buckets[7]
    assert late.optimizer_initialized and late.params_initialized
    assert late._updater is port._buckets[10]._updater


def test_save_checkpoint_loads_in_the_other_package(tmp_path):
    port, jax = _lm_modules()
    _run(port, jax, _batches([10, 5], lm=True), lm=True, borrow=True)
    port.save_checkpoint(str(tmp_path / "port"), 1)
    jax.save_checkpoint(str(tmp_path / "jax"), 1)
    jsym, jarg, _ = jmx.model.load_checkpoint(str(tmp_path / "port"), 1)
    psym, parg, _ = mx.model.load_checkpoint(str(tmp_path / "jax"), 1)
    want_p, _ = port.get_params()
    want_j, _ = jax.get_params()
    assert jsym.list_arguments() == psym.list_arguments()
    for name, v in jarg.items():
        np.testing.assert_array_equal(v.asnumpy(), want_p[name].asnumpy())
    for name, v in parg.items():
        np.testing.assert_array_equal(v.asnumpy(), want_j[name].asnumpy())


def test_fit_trains_the_buckets_with_speedometer(caplog):
    """``BucketingModule.fit`` over ``train_ptb.py``'s iterator at a
    small size: "adam", ``Perplexity``, ``Speedometer``; the epoch's
    buckets, one updater, falling perplexity."""
    import logging

    from chip_smoke import bucket_sentence_iter, synthetic_corpus

    sentences = synthetic_corpus(120, VOCAB, seed=0)
    it = bucket_sentence_iter(mx)(sentences, BATCH, [10, 20, 30, 40], VOCAB)
    model = mx.mod.BucketingModule(sym_gen_factory(mx, VOCAB, 8, 16, BATCH),
                                   default_bucket_key=it.default_bucket_key,
                                   context=mx.cpu())
    seen = []
    with caplog.at_level(logging.INFO):
        model.fit(it, eval_metric=mx.metric.Perplexity(), optimizer="adam",
                  optimizer_params={"learning_rate": 0.01},
                  initializer=mx.init.Xavier(), num_epoch=2,
                  batch_end_callback=[
                      lambda p: seen.append(p.eval_metric.get()[1]),
                      mx.callback.Speedometer(BATCH, 5)])
    assert sorted(model._buckets) == [10, 20, 30, 40]
    assert len({id(m._updater) for m in model._buckets.values()}) == 1
    assert "Train-perplexity" in caplog.text
    assert np.isfinite(seen).all()
    assert seen[-1] < seen[0]
