"""Carry weights into a port block by structural name.

``load_jax_params(block, {structural_name: numpy.ndarray})`` copies
parameter values, such as those of the same model built with the JAX
package (``{n: p.data().asnumpy() for n, p in
jax_block._collect_params_with_structure().items()}``), into a block of
this package. Names are matched by ``_collect_params_with_structure``
(attribute paths such as ``encoder.1.attn.query.weight``), which do not
depend on the global name counters that make prefixes. Layouts are the
JAX package's: a FullyConnected weight is ``(num_hidden, in_units)``.

Any missing name, extra name, shape mismatch or dtype mismatch raises;
a parameter whose shape was deferred takes the array's shape.

``export_params(block)`` is the inverse: ``{structural_name:
numpy.ndarray}`` of the block's current values, in the same layout, so
tests can compare weights after training with the JAX package's.

``load_jax_model(symbol_json, arg_params, aux_params)`` carries a graph
and its parameters across, such as a JAX ``quantize_model`` result
(``qsym.tojson()`` and ``{name: nd.asnumpy()}`` dicts);
``load_jax_checkpoint(prefix, epoch)`` reads the file pair of a JAX
``save_checkpoint``. Both return the port's ``(Symbol, arg_params,
aux_params)`` with every dtype kept (int8 weights stay int8).
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError, canonical_dtype

__all__ = ["load_jax_params", "export_params", "load_jax_model",
           "load_jax_checkpoint"]


def load_jax_params(block, params):
    """Copy ``params`` into ``block``'s parameters, keeping each
    parameter's device. Returns the number of parameters set."""
    targets = block._collect_params_with_structure()
    missing = sorted(set(targets) - set(params))
    extra = sorted(set(params) - set(targets))
    if missing or extra:
        raise MXNetError(f"load_jax_params: missing {missing}, "
                         f"unexpected {extra}")
    for name, p in targets.items():
        arr = _np.asarray(params[name])
        if canonical_dtype(arr.dtype) != p.dtype:
            raise MXNetError(f"load_jax_params: {name} is {arr.dtype}, the "
                             f"parameter is {p.dtype}")
        known = p.shape is not None and all(s > 0 for s in p.shape)
        compatible = p.shape is not None and len(p.shape) == arr.ndim and \
            all(s in (0, n) for s, n in zip(p.shape, arr.shape))
        if (known and tuple(p.shape) != arr.shape) or not compatible:
            raise MXNetError(f"load_jax_params: {name} has shape "
                             f"{arr.shape}, the parameter {p.shape}")
        p.set_data(arr)
    return len(targets)


def export_params(block):
    """``{structural_name: numpy.ndarray}`` copies of ``block``'s
    parameter values (host copies; bfloat16 widens to float32)."""
    return {name: p.data().asnumpy()
            for name, p in block._collect_params_with_structure().items()}


def _checked_model(sym, args, auxs):
    for params, names in ((args, sym.list_arguments()),
                          (auxs, sym.list_auxiliary_states())):
        extra = sorted(set(params) - set(names))
        if extra:
            raise MXNetError(f"{extra} are not inputs of the graph")
    unset = [n for n in sym.list_inputs() if n not in args and n not in auxs]
    if len(unset) > 1:
        raise MXNetError(f"no values for {unset[1:]} (besides the data "
                         f"input {unset[0]!r})")
    return sym, args, auxs


def load_jax_model(symbol_json, arg_params, aux_params=None, ctx=None):
    """``(Symbol, {name: NDArray}, {name: NDArray})`` of a JAX graph's
    JSON and its ``{name: numpy.ndarray}`` parameter dicts, the arrays on
    ``ctx`` (default: the current context) in their own dtypes. A
    parameter the graph does not use, or a graph input other than one
    data input without a value, raises."""
    from . import symbol
    from .ndarray import array

    return _checked_model(
        symbol.load_json(symbol_json),
        {k: array(_np.asarray(v), ctx=ctx) for k, v in arg_params.items()},
        {k: array(_np.asarray(v), ctx=ctx)
         for k, v in (aux_params or {}).items()})


def load_jax_checkpoint(prefix, epoch, ctx=None):
    """Like :func:`load_jax_model`, from the ``prefix-symbol.json`` /
    ``prefix-%04d.params`` pair a JAX ``save_checkpoint`` wrote (the
    same file format as the port's, bfloat16 included)."""
    from .model import load_checkpoint

    return _checked_model(*load_checkpoint(prefix, epoch, ctx=ctx))
