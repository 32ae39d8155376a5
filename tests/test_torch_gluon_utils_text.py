"""``gluon.utils`` and ``contrib.text`` of the port against the JAX
package's on the CPU: ``clip_global_norm`` (the same total and warning;
the port scales the arrays in place, where the JAX function rebinds
them), ``split_data`` and ``split_and_load`` on CPU contexts, ``check_sha1``,
and ``Vocabulary``, ``count_tokens_from_str`` and ``CustomEmbedding``
(``GloVe``/``FastText`` read only a local file, and raise where it is
absent). ``download`` is not called."""
import collections
import hashlib
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.contrib import text as jtext
from mxnet_tpu.gluon import utils as jutils
from mxnet_tpu_torch.contrib import text
from mxnet_tpu_torch.gluon import utils

RTOL = 1e-6   # float32 norms summed in float64 on the host by both


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mx.cpu():
        yield


def _arrays(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32)
            for s in ((3, 4), (7,), (2, 2, 5))]


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_global_norm_matches_jax_in_place(max_norm):
    values = _arrays()
    port = [mx.nd.array(v) for v in values]
    ptrs = [a._data.data_ptr() for a in port]
    jax = [jmx.nd.array(v) for v in values]
    total = utils.clip_global_norm(port, max_norm)
    jtotal = jutils.clip_global_norm(jax, max_norm)
    assert isinstance(total, float)
    np.testing.assert_allclose(total, jtotal, rtol=RTOL)
    assert [a._data.data_ptr() for a in port] == ptrs
    for p, j, v in zip(port, jax, values):
        np.testing.assert_allclose(p.asnumpy(), j.asnumpy(), rtol=RTOL,
                                   atol=1e-7)
        if max_norm > total:
            np.testing.assert_array_equal(p.asnumpy(), v)
    if max_norm < total:
        got = np.sqrt(sum((p.asnumpy().astype(np.float64) ** 2).sum()
                          for p in port))
        np.testing.assert_allclose(got, max_norm, rtol=1e-5)


def test_clip_global_norm_scales_parameter_gradients_in_place():
    """The gradient buffers a ``gluon.Trainer`` reads are the ones
    scaled."""
    dense = mx.gluon.nn.Dense(3, in_units=4)
    dense.initialize()
    with mx.autograd.record():
        loss = (dense(mx.nd.array(_arrays()[0])) * 100).sum()
    loss.backward()
    grads = [p.grad() for p in dense.collect_params().values()]
    utils.clip_global_norm(grads, 1.0)
    again = [p.grad() for p in dense.collect_params().values()]
    norm = np.sqrt(sum((g.asnumpy() ** 2).sum() for g in again))
    np.testing.assert_allclose(norm, 1.0, rtol=1e-5)


def test_clip_global_norm_warns_on_nan_as_jax_does():
    values = _arrays()
    values[1][2] = np.nan
    with pytest.warns(UserWarning, match="nan or inf") as port_w:
        ptotal = utils.clip_global_norm([mx.nd.array(v) for v in values], 1)
    with pytest.warns(UserWarning, match="nan or inf") as jax_w:
        jtotal = jutils.clip_global_norm([jmx.nd.array(v) for v in values],
                                         1)
    assert str(port_w[0].message) == str(jax_w[0].message)
    assert np.isnan(ptotal) and np.isnan(jtotal)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        utils.clip_global_norm([mx.nd.array(v) for v in values], 1,
                               check_isfinite=False)
    with pytest.raises(ValueError):
        utils.clip_global_norm([], 1.0)


@pytest.mark.parametrize("axis,n,even", [(0, 2, True), (1, 3, False),
                                         (0, 4, True)])
def test_split_data_and_load_match_jax(axis, n, even):
    x = np.arange(8 * 5, dtype=np.float32).reshape(8, 5)
    port = utils.split_data(mx.nd.array(x), n, axis, even_split=even)
    jax = jutils.split_data(jmx.nd.array(x), n, axis, even_split=even)
    assert [p.shape for p in port] == [tuple(j.shape) for j in jax]
    for p, j in zip(port, jax):
        np.testing.assert_array_equal(p.asnumpy(), j.asnumpy())
    loaded = utils.split_and_load(x, [mx.cpu(i) for i in range(n)], axis,
                                  even_split=even)
    jloaded = jutils.split_and_load(x, [jmx.cpu(i) for i in range(n)],
                                    axis, even_split=even)
    for p, j in zip(loaded, jloaded):
        np.testing.assert_array_equal(p.asnumpy(), j.asnumpy())
    assert all(p.context.device_type == "cpu" for p in loaded)
    whole = utils.split_and_load(mx.nd.array(x), [mx.cpu()])
    np.testing.assert_array_equal(whole[0].asnumpy(), x)


def test_split_data_uneven_raises():
    with pytest.raises(ValueError, match="evenly split"):
        utils.split_data(mx.nd.array(np.zeros((5, 2))), 2)


def test_check_sha1(tmp_path):
    f = tmp_path / "blob"
    f.write_bytes(b"mxnet" * 1000)
    digest = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    assert utils.check_sha1(str(f), digest)
    assert utils.check_sha1(str(f), digest) == jutils.check_sha1(str(f),
                                                                 digest)
    assert not utils.check_sha1(str(f), "0" * 40)


TEXT = "the cat sat\non the mat\nthe dog Sat on The log\n"


@pytest.mark.parametrize("kw", [{}, {"to_lower": True},
                                {"token_delim": "a", "seq_delim": "\n"}])
def test_count_tokens_from_str_matches_jax(kw):
    got = text.utils.count_tokens_from_str(TEXT, **kw)
    assert got == jtext.utils.count_tokens_from_str(TEXT, **kw)
    more = text.utils.count_tokens_from_str("cat cat", counter_to_update=
                                            collections.Counter(got))
    assert more["cat"] == got["cat"] + 2


@pytest.mark.parametrize("kw", [
    {}, {"most_freq_count": 3}, {"min_freq": 2},
    {"reserved_tokens": ["<pad>", "<bos>"], "unknown_token": "<u>"}])
def test_vocabulary_matches_jax(kw):
    counter = text.utils.count_tokens_from_str(TEXT)
    vocab = text.Vocabulary(counter, **kw)
    jvocab = jtext.Vocabulary(counter, **kw)
    assert vocab.idx_to_token == jvocab.idx_to_token
    assert vocab.token_to_idx == jvocab.token_to_idx
    assert len(vocab) == len(jvocab)
    assert vocab.unknown_token == jvocab.unknown_token
    assert vocab.reserved_tokens == jvocab.reserved_tokens
    toks = ["the", "zebra", "mat"]
    assert vocab.to_indices(toks) == jvocab.to_indices(toks)
    assert vocab.to_indices("zebra") == 0
    assert vocab.to_tokens([0, 1]) == jvocab.to_tokens([0, 1])
    with pytest.raises(ValueError):
        vocab.to_tokens(len(vocab))


def test_vocabulary_rejects_what_jax_rejects():
    for kw in ({"min_freq": 0}, {"reserved_tokens": ["a", "a"]},
               {"reserved_tokens": ["<unk>"]}):
        with pytest.raises(ValueError):
            text.Vocabulary(**kw)
        with pytest.raises(ValueError):
            jtext.Vocabulary(**kw)


def _vector_file(tmp_path, header=False):
    lines = ["cat 0.1 0.2 0.3", "dog 0.4 0.5 0.6", "<unk> 9 9 9",
             "cat 7 7 7", "bad", "mat 1 2 3"]
    f = tmp_path / "vecs.txt"
    f.write_text(("3 3\n" if header else "") + "\n".join(lines) + "\n")
    return str(f)


@pytest.mark.parametrize("header", [False, True])
def test_custom_embedding_matches_jax(tmp_path, header):
    path = _vector_file(tmp_path, header)
    emb = text.embedding.CustomEmbedding(path)
    jemb = jtext.embedding.CustomEmbedding(path)
    assert emb.idx_to_token == jemb.idx_to_token
    assert emb.vec_len == jemb.vec_len == 3
    np.testing.assert_array_equal(emb.idx_to_vec.asnumpy(),
                                  jemb.idx_to_vec.asnumpy())
    toks = ["dog", "zebra", "cat"]
    np.testing.assert_array_equal(emb.get_vecs_by_tokens(toks).asnumpy(),
                                  jemb.get_vecs_by_tokens(toks).asnumpy())
    np.testing.assert_array_equal(
        emb.get_vecs_by_tokens("DOG", lower_case_backup=True).asnumpy(),
        jemb.get_vecs_by_tokens("DOG", lower_case_backup=True).asnumpy())
    new = np.ones((1, 3), np.float32) * 4
    emb.update_token_vectors(["mat"], mx.nd.array(new))
    jemb.update_token_vectors(["mat"], jmx.nd.array(new))
    np.testing.assert_array_equal(emb.idx_to_vec.asnumpy(),
                                  jemb.idx_to_vec.asnumpy())
    with pytest.raises(ValueError, match="unknown"):
        emb.update_token_vectors("zebra", mx.nd.array(new[0]))


def test_embedding_over_a_vocabulary_matches_jax(tmp_path):
    path = _vector_file(tmp_path)
    counter = text.utils.count_tokens_from_str("cat mat fish cat")
    vocab, jvocab = text.Vocabulary(counter), jtext.Vocabulary(counter)
    emb = text.embedding.CustomEmbedding(path, vocabulary=vocab)
    jemb = jtext.embedding.CustomEmbedding(path, vocabulary=jvocab)
    assert emb.idx_to_token == jemb.idx_to_token == vocab.idx_to_token
    np.testing.assert_array_equal(emb.idx_to_vec.asnumpy(),
                                  jemb.idx_to_vec.asnumpy())
    both = text.embedding.CompositeEmbedding(vocab, [emb, emb])
    jboth = jtext.embedding.CompositeEmbedding(jvocab, [jemb, jemb])
    assert both.vec_len == jboth.vec_len == 6
    np.testing.assert_array_equal(both.idx_to_vec.asnumpy(),
                                  jboth.idx_to_vec.asnumpy())


def test_pretrained_embeddings_read_only_the_local_cache(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("MXNET_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="glove.6B.50d.txt"):
        text.embedding.create("glove", pretrained_file_name=
                              "glove.6B.50d.txt")
    with pytest.raises(KeyError):
        text.embedding.GloVe(pretrained_file_name="nope.txt")
    target = tmp_path / "embeddings" / "fasttext"
    target.mkdir(parents=True)
    (target / "wiki.simple.vec").write_text("2 2\nhi 1 2\nyo 3 4\n")
    ft = text.embedding.FastText()
    jft = jtext.embedding.FastText()
    assert ft.idx_to_token == jft.idx_to_token == ["<unk>", "hi", "yo"]
    assert text.embedding.get_pretrained_file_names("glove") == \
        jtext.embedding.get_pretrained_file_names("glove")
