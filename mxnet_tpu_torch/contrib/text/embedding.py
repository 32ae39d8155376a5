"""Token embeddings: a vocabulary with an ``(len, vec_len)`` NDArray of
vectors.

A copy of ``mxnet_tpu/contrib/text/embedding.py`` (MXNet 1.x
``python/mxnet/contrib/text/embedding.py``) over the port's NDArrays: the
table is made on the current context (the card unless a ``with
mx.cpu():`` says otherwise). Pretrained vectors in the GloVe / fastText
text formats; MXNet downloads their archives on demand (embedding.py:200),
this package fetches nothing over a network, so ``GloVe``/``FastText``
read their files from the local cache directory
(``$MXNET_HOME/embeddings/<name>/``, default ``~/.mxnet/embeddings``) and
raise naming where to place the file, as the JAX package does.
``CustomEmbedding`` loads any whitespace-delimited vector file.
"""
from __future__ import annotations

import io
import os

import numpy as np

from . import vocab as _vocab

__all__ = ["register", "create", "get_pretrained_file_names",
           "TokenEmbedding", "GloVe", "FastText", "CustomEmbedding",
           "CompositeEmbedding"]

_EMBEDDING_REGISTRY = {}


def register(embedding_cls):
    """Register a `_TokenEmbedding` subclass under its lowercase name
    (parity: embedding.py:40)."""
    name = embedding_cls.__name__.lower()
    _EMBEDDING_REGISTRY[name] = embedding_cls
    return embedding_cls


def create(embedding_name, **kwargs):
    """Instantiate a registered embedding, e.g.
    ``create('glove', pretrained_file_name='glove.6B.50d.txt')``
    (parity: embedding.py:63)."""
    name = embedding_name.lower()
    if name not in _EMBEDDING_REGISTRY:
        raise KeyError(
            f"unknown embedding {embedding_name!r}; registered: "
            f"{sorted(_EMBEDDING_REGISTRY)}")
    return _EMBEDDING_REGISTRY[name](**kwargs)


def get_pretrained_file_names(embedding_name=None):
    """Known pretrained file names, per embedding or as a dict
    (parity: embedding.py:90)."""
    if embedding_name is not None:
        return list(
            _EMBEDDING_REGISTRY[embedding_name.lower()]
            .pretrained_file_names)
    return {name: list(cls.pretrained_file_names)
            for name, cls in _EMBEDDING_REGISTRY.items()}


class TokenEmbedding(_vocab.Vocabulary):
    """Base token embedding: a Vocabulary plus an idx->vector NDArray
    table (parity: embedding.py:133 `_TokenEmbedding`).

    Subclasses provide the vector source; this class owns indexing,
    lookup and update. Vectors live in an `mx.nd.NDArray` of shape
    ``(len(self), vec_len)``; row 0 (the unknown token) comes from
    `init_unknown_vec`.
    """

    pretrained_file_names = ()

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._vec_len = None
        self._idx_to_vec = None

    # ------------------------------------------------------------- loading --
    def _load_embedding(self, pretrained_file_path, elem_delim=" ",
                        init_unknown_vec=None, encoding="utf8"):
        """Parse a text vector file: one token per line, vector elements
        separated by `elem_delim` (parity: embedding.py:232)."""
        from ... import nd

        pretrained_file_path = os.path.expanduser(pretrained_file_path)
        if not os.path.isfile(pretrained_file_path):
            raise FileNotFoundError(
                f"embedding file not found: {pretrained_file_path}")
        vecs = []
        vec_len = None
        loaded_unknown_vec = None
        with io.open(pretrained_file_path, "r", encoding=encoding) as f:
            for line_num, line in enumerate(f):
                parts = line.rstrip().split(elem_delim)
                if line_num == 0 and len(parts) == 2:
                    continue  # fastText header line: "<count> <dim>"
                token, elems = parts[0], parts[1:]
                if len(elems) <= 1:
                    continue  # malformed line — reference warns and skips
                if vec_len is None:
                    vec_len = len(elems)
                elif len(elems) != vec_len:
                    continue
                if token == self.unknown_token:
                    # the file's own unknown vector becomes row 0
                    # (parity: embedding.py:262 loaded_unknown_vec)
                    if loaded_unknown_vec is None:
                        loaded_unknown_vec = np.asarray(elems,
                                                        dtype=np.float32)
                    continue
                if token in self._token_to_idx:
                    continue  # first occurrence wins
                self._token_to_idx[token] = len(self._idx_to_token)
                self._idx_to_token.append(token)
                vecs.append(np.asarray(elems, dtype=np.float32))
        if vec_len is None:
            raise ValueError(
                f"no valid vectors found in {pretrained_file_path}")
        self._vec_len = vec_len
        table = np.zeros((len(self), vec_len), dtype=np.float32)
        # file-provided unknown vector wins over the initializer
        # (parity: embedding.py:300)
        if loaded_unknown_vec is not None:
            table[0] = loaded_unknown_vec
        elif init_unknown_vec is not None:
            unk = init_unknown_vec(shape=(vec_len,))
            table[0] = unk.asnumpy() if hasattr(unk, "asnumpy") \
                else np.asarray(unk)
        if vecs:
            table[len(self) - len(vecs):] = np.stack(vecs)
        self._idx_to_vec = nd.array(table)

    def _build_from_vocabulary(self, vocabulary, source_embeddings):
        """Restrict `source_embeddings` to `vocabulary`'s tokens
        (parity: embedding.py:349)."""
        from ... import nd

        parts = [emb.get_vecs_by_tokens(list(vocabulary.idx_to_token))
                 for emb in source_embeddings]
        self._token_to_idx = dict(vocabulary.token_to_idx)
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._unknown_token = vocabulary.unknown_token
        self._reserved_tokens = vocabulary.reserved_tokens
        self._idx_to_vec = nd.concat(*parts, dim=1) if len(parts) > 1 \
            else parts[0]
        self._vec_len = int(self._idx_to_vec.shape[1])

    # -------------------------------------------------------------- lookup --
    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self):
        return self._idx_to_vec

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        """Vectors for token(s); unknown tokens get row 0
        (parity: embedding.py:370)."""
        from ... import nd

        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        if lower_case_backup:
            idxs = [self._token_to_idx.get(
                t, self._token_to_idx.get(t.lower(), 0)) for t in toks]
        else:
            idxs = [self._token_to_idx.get(t, 0) for t in toks]
        vecs = nd.take(self._idx_to_vec,
                       nd.array(idxs, dtype="int32",
                                ctx=self._idx_to_vec.context))
        return vecs[0] if single else vecs

    def update_token_vectors(self, tokens, new_vectors):
        """Overwrite rows for known tokens (parity: embedding.py:415)."""
        assert self._idx_to_vec is not None, "no embedding loaded"
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        if single and len(new_vectors.shape) == 1:
            new_vectors = new_vectors.reshape((1, -1))
        idxs = []
        for t in toks:
            if t not in self._token_to_idx:
                raise ValueError(
                    f"token {t!r} is unknown; only vectors of indexed "
                    "tokens can be updated")
            idxs.append(self._token_to_idx[t])
        # row-wise device-side writes; no whole-table host round-trip
        new_vectors = new_vectors.reshape((len(idxs), -1))
        for row, i in enumerate(idxs):
            self._idx_to_vec[i] = new_vectors[row]

    @classmethod
    def _check_pretrained_file_names(cls, pretrained_file_name):
        if cls.pretrained_file_names and \
                pretrained_file_name not in cls.pretrained_file_names:
            raise KeyError(
                f"{pretrained_file_name!r} is not a known "
                f"{cls.__name__} file; choose from "
                f"{sorted(cls.pretrained_file_names)}")

    @classmethod
    def _resolve_local_file(cls, embedding_root, pretrained_file_name):
        """Local-cache stand-in for the reference's archive download
        (embedding.py:200): the vector file must already sit at
        ``<root>/<clsname>/<file>``."""
        embedding_root = os.path.expanduser(embedding_root)
        path = os.path.join(embedding_root, cls.__name__.lower(),
                            pretrained_file_name)
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"pretrained file {pretrained_file_name!r} not present at "
                f"{path}; this package fetches nothing over a network: place "
                "the extracted vector file there (MXNet would download it "
                "from apache-mxnet.s3)")
        return path


# keep the reference's private alias importable (embedding.py:133)
_TokenEmbedding = TokenEmbedding


def _default_embedding_root():
    return os.path.join(
        os.environ.get("MXNET_HOME", os.path.join("~", ".mxnet")),
        "embeddings")


@register
class GloVe(TokenEmbedding):
    """GloVe vectors from a local file (parity: embedding.py:481)."""

    pretrained_file_names = (
        "glove.42B.300d.txt", "glove.6B.50d.txt", "glove.6B.100d.txt",
        "glove.6B.200d.txt", "glove.6B.300d.txt", "glove.840B.300d.txt",
        "glove.twitter.27B.25d.txt", "glove.twitter.27B.50d.txt",
        "glove.twitter.27B.100d.txt", "glove.twitter.27B.200d.txt")

    def __init__(self, pretrained_file_name="glove.840B.300d.txt",
                 embedding_root=None, init_unknown_vec=None,
                 vocabulary=None, **kwargs):
        self._check_pretrained_file_names(pretrained_file_name)
        super().__init__(**kwargs)
        path = self._resolve_local_file(
            embedding_root or _default_embedding_root(),
            pretrained_file_name)
        self._load_embedding(path, " ",
                             init_unknown_vec=init_unknown_vec)
        if vocabulary is not None:
            self._build_from_vocabulary(vocabulary, [self])


@register
class FastText(TokenEmbedding):
    """fastText vectors from a local file (parity: embedding.py:553)."""

    pretrained_file_names = (
        "wiki.en.vec", "wiki.simple.vec", "wiki.zh.vec", "wiki.fr.vec",
        "wiki.de.vec", "wiki.es.vec", "wiki.ru.vec", "wiki.ja.vec",
        "crawl-300d-2M.vec")

    def __init__(self, pretrained_file_name="wiki.simple.vec",
                 embedding_root=None, init_unknown_vec=None,
                 vocabulary=None, **kwargs):
        self._check_pretrained_file_names(pretrained_file_name)
        super().__init__(**kwargs)
        path = self._resolve_local_file(
            embedding_root or _default_embedding_root(),
            pretrained_file_name)
        self._load_embedding(path, " ",
                             init_unknown_vec=init_unknown_vec)
        if vocabulary is not None:
            self._build_from_vocabulary(vocabulary, [self])


@register
class CustomEmbedding(TokenEmbedding):
    """Vectors from any local text file: ``token<delim>e1<delim>e2...``
    per line (parity: embedding.py:635)."""

    def __init__(self, pretrained_file_path, elem_delim=" ",
                 encoding="utf8", init_unknown_vec=None, vocabulary=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._load_embedding(pretrained_file_path, elem_delim,
                             init_unknown_vec=init_unknown_vec,
                             encoding=encoding)
        if vocabulary is not None:
            self._build_from_vocabulary(vocabulary, [self])


class CompositeEmbedding(TokenEmbedding):
    """Concatenate several embeddings over one vocabulary
    (parity: embedding.py:677)."""

    def __init__(self, vocabulary, token_embeddings):
        if not isinstance(token_embeddings, (list, tuple)):
            token_embeddings = [token_embeddings]
        super().__init__()
        self._build_from_vocabulary(vocabulary, token_embeddings)
