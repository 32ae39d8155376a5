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
"""
from __future__ import annotations

import numpy as _np

from .base import MXNetError, canonical_dtype

__all__ = ["load_jax_params", "export_params"]


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
