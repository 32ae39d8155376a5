"""Tokenization helpers: a copy of ``mxnet_tpu/contrib/text/utils.py``
(MXNet 1.x ``python/mxnet/contrib/text/utils.py:33``)."""
from __future__ import annotations

import re
from collections import Counter

__all__ = ["count_tokens_from_str"]


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """Count tokens in `source_str`, splitting on `token_delim` and
    `seq_delim`; returns (or updates) a `collections.Counter`."""
    source_str = filter(None, re.split(
        re.escape(token_delim) + "|" + re.escape(seq_delim), source_str))
    if to_lower:
        source_str = (t.lower() for t in source_str)
    counter = counter_to_update if counter_to_update is not None else Counter()
    counter.update(source_str)
    return counter
