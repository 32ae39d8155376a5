"""Indexed vocabulary: a copy of ``mxnet_tpu/contrib/text/vocab.py``
(MXNet 1.x ``python/mxnet/contrib/text/vocab.py:28``)."""
from __future__ import annotations

__all__ = ["Vocabulary"]


class Vocabulary:
    """Token index built from a `collections.Counter`.

    Indexing order: unknown token at 0, then reserved tokens, then counter
    keys by descending frequency (ties broken alphabetically), truncated
    to `most_freq_count` and filtered by `min_freq` — the reference's
    ordering contract (vocab.py:107), which checkpointed embedding
    matrices depend on.
    """

    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("min_freq must be >= 1")
        if reserved_tokens is not None:
            reserved = set(reserved_tokens)
            if len(reserved) != len(reserved_tokens):
                raise ValueError("reserved_tokens must not be duplicated")
            if unknown_token in reserved:
                raise ValueError(
                    "unknown_token must not appear in reserved_tokens")
        self._unknown_token = unknown_token
        self._reserved_tokens = (list(reserved_tokens)
                                 if reserved_tokens is not None else None)
        self._idx_to_token = [unknown_token] + (self._reserved_tokens or [])
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}
        if counter is not None:
            self._index_counter_keys(counter, most_freq_count, min_freq)

    def _index_counter_keys(self, counter, most_freq_count, min_freq):
        existing = set(self._idx_to_token)
        pairs = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
        kept = 0
        for token, freq in pairs:
            if freq < min_freq or (most_freq_count is not None
                                   and kept >= most_freq_count):
                break
            if token in existing:
                continue
            self._token_to_idx[token] = len(self._idx_to_token)
            self._idx_to_token.append(token)
            kept += 1

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """Token(s) -> index/indices; unknown tokens map to index 0."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        out = [self._token_to_idx.get(t, 0) for t in toks]
        return out[0] if single else out

    def to_tokens(self, indices):
        """Index/indices -> token(s); out-of-range raises ValueError."""
        single = isinstance(indices, int)
        idxs = [indices] if single else indices
        out = []
        for i in idxs:
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError(f"token index {i} out of range "
                                 f"[0, {len(self._idx_to_token)})")
            out.append(self._idx_to_token[i])
        return out[0] if single else out
