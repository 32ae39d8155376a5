"""Gluon utilities: ``split_data``, ``split_and_load``,
``clip_global_norm``, ``check_sha1``, ``download``.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (MXNet 1.x
``python/mxnet/gluon/utils.py``). ``clip_global_norm`` scales the arrays
in place (the JAX function rebinds each handle to a new array): the
arrays are the parameters' gradient buffers, which ``gluon.Trainer`` and
a captured backward read through their tensors. It reads the card once
per call (the JAX function once per array) and sums the squares of the
per-array norms on the host in float64, as the JAX function does.
"""
from __future__ import annotations

import hashlib
import math
import os
import shutil
import warnings

import torch

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (the last
    takes the remainder unless ``even_split``, which requires none)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}")
    step = size // num_slice
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis`` over ``ctx_list``, one slice
    copied to each context."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place by ``max_norm / (norm + 1e-8)`` when
    their global L2 norm exceeds ``max_norm``; returns the norm (a
    float). A non-finite norm warns when ``check_isfinite``."""
    if not arrays:
        raise ValueError("clip_global_norm needs at least one array")
    tensors = [a._data for a in arrays]
    with torch.no_grad():
        norms = torch.stack([torch.linalg.vector_norm(t).to(torch.float32)
                             for t in tensors]).tolist()
    total = math.sqrt(sum(n * n for n in norms))
    if check_isfinite and not math.isfinite(total):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            torch._foreach_mul_(tensors, scale)
    return total


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 digest is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The JAX package's ``download``: an existing file at the target
    (with the right SHA-1, when given) or a ``file://`` URL is served;
    any other URL raises, as the port fetches nothing over a network."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if os.path.exists(fname) and not overwrite and (
            not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    if url.startswith("file://"):
        shutil.copyfile(url[7:], fname)
        return fname
    raise RuntimeError(
        f"download({url!r}): this package fetches nothing over a network; "
        "place the file at the target path instead")
