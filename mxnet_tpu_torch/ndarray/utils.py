"""``mx.nd.save`` / ``mx.nd.load``: the ``.params`` file format.

Counterpart of ``mxnet_tpu/ndarray/utils.py:34-75``, byte for byte the
same container: an NPZ (zip of ``.npy``) holding a dict of arrays under
their names, or a list under ``__list__:<i>``; bfloat16 arrays are
stored as their raw uint16 bits with the name suffix ``:bf16`` (npy has
no bfloat16). Every other dtype, int8 included, is stored as it is. A
file written by either package loads in the other.
"""
from __future__ import annotations

import numpy as _np
import torch

from .ndarray import NDArray, array

__all__ = ["save", "load"]

_LIST_PREFIX = "__list__:"
_BF16_SUFFIX = ":bf16"


def _to_numpy(arr):
    t = arr._data.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_np.uint16), True
    return t.numpy(), False


def save(fname, data):
    """Save one NDArray, a list of them or a ``{name: NDArray}`` dict."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        items = ((f"{_LIST_PREFIX}{i}", a) for i, a in enumerate(data))
    elif isinstance(data, dict):
        items = data.items()
    else:
        raise TypeError(f"save expects a list or dict of NDArray, got "
                        f"{type(data).__name__}")
    payload = {}
    for key, arr in items:
        np_arr, is_bf16 = _to_numpy(arr)
        payload[key + (_BF16_SUFFIX if is_bf16 else "")] = np_arr
    with open(fname, "wb") as f:
        _np.savez(f, **payload)


def _restore(np_arr, is_bf16, ctx):
    if not is_bf16:
        return array(np_arr, ctx=ctx)
    if np_arr.dtype == _np.uint16:
        t = torch.from_numpy(np_arr.view(_np.int16)).view(torch.bfloat16)
    else:  # a float array tagged bf16
        t = torch.from_numpy(np_arr).to(torch.bfloat16)
    return NDArray(t, ctx=ctx)


def load(fname, ctx=None):
    """Arrays saved by :func:`save` (a list or a dict, as saved), on
    ``ctx`` (default: the current context)."""
    items = {}
    with _np.load(fname, allow_pickle=False) as z:
        for key in z.files:
            is_bf16 = key.endswith(_BF16_SUFFIX)
            name = key[:-len(_BF16_SUFFIX)] if is_bf16 else key
            items[name] = _restore(z[key], is_bf16, ctx)
    if all(k.startswith(_LIST_PREFIX) for k in items):
        return [v for _, v in sorted(
            items.items(), key=lambda kv: int(kv[0][len(_LIST_PREFIX):]))]
    return items
