"""Checkpoints of a graph and its parameters.

Counterpart of ``mxnet_tpu/model.py`` (``save_checkpoint`` :16,
``load_params`` :32, ``load_checkpoint`` :64): ``prefix-symbol.json`` +
``prefix-%04d.params``, the parameters keyed ``arg:<name>`` /
``aux:<name>``. The files are the JAX package's format both ways.
Each file is written to a temporary name and renamed into place, so a
run killed during a save leaves the previous file whole.
"""
from __future__ import annotations

import os
import zipfile

__all__ = ["save_checkpoint", "load_params", "load_checkpoint"]


def _atomic_write(path, write):
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        write(tmp)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``symbol`` (unless None) and the ``{name: NDArray}``
    parameter dicts."""
    from .ndarray import utils as nd_utils

    if symbol is not None:
        _atomic_write(f"{prefix}-symbol.json", symbol.save)
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    _atomic_write(f"{prefix}-{epoch:04d}.params",
                  lambda tmp: nd_utils.save(tmp, save_dict))


def load_params(fname, ctx=None):
    """``(arg_params, aux_params)`` of a params file, on ``ctx``
    (default: the current context). Untagged names count as arguments."""
    from .ndarray import utils as nd_utils

    if not os.path.exists(fname):
        raise FileNotFoundError(f"params file not found: {fname!r}")
    try:
        loaded = nd_utils.load(fname, ctx=ctx)
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
        raise ValueError(f"corrupt params file {fname!r}: "
                         f"{type(e).__name__}: {e}") from e
    arg_params, aux_params = {}, {}
    for k, v in loaded.items():
        if k.startswith("aux:"):
            aux_params[k[4:]] = v
        else:
            arg_params[k[4:] if k.startswith("arg:") else k] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch, ctx=None):
    """``(symbol, arg_params, aux_params)``, the parameters on ``ctx``."""
    from . import symbol as sym_mod

    sym_file = f"{prefix}-symbol.json"
    if not os.path.exists(sym_file):
        raise FileNotFoundError(f"symbol file not found: {sym_file!r} "
                                f"(checkpoint prefix {prefix!r}, epoch "
                                f"{epoch})")
    symbol = sym_mod.load(sym_file)
    arg_params, aux_params = load_params(f"{prefix}-{epoch:04d}.params",
                                         ctx=ctx)
    return symbol, arg_params, aux_params
