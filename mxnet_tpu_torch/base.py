"""Foundation helpers: the error type and dtype names.

Counterpart of ``mxnet_tpu/base.py``. The port keeps its own copy of the
pieces it needs: ``MXNetError`` and dtype canonicalisation, here mapping
MXNet dtype names onto ``torch.dtype`` objects.
"""
from __future__ import annotations

import numpy as _np
import torch

__all__ = ["MXNetError", "canonical_dtype", "dtype_name", "numpy_dtype"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: dmlc error -> MXNetError)."""


_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def canonical_dtype(dtype) -> torch.dtype:
    """Normalise a dtype-ish value (name, numpy dtype or type, torch
    dtype; None means float32) to a ``torch.dtype``."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise TypeError(f"unsupported dtype {dtype!r}")
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def dtype_name(dtype) -> str:
    """The MXNet name of a dtype (``"float32"``, ``"bfloat16"``, ...)."""
    return _NAMES[canonical_dtype(dtype)]


def numpy_dtype(dtype):
    """The numpy dtype a host copy of ``dtype`` takes; bfloat16 has no
    numpy type and widens to float32."""
    name = dtype_name(dtype)
    return _np.dtype("float32" if name == "bfloat16" else name)
