"""NDArray: a thin handle over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``. The handle owns one
tensor, ``_data``; mutation is by rebinding that tensor (README
"Design"), so a Parameter's handle can be given new values without
callers holding stale references. Placement is explicit: an array lives
where its Context says, the card by default.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import canonical_dtype, numpy_dtype
from ..context import Context, current_context
from ..ops import registry as _reg

__all__ = ["NDArray", "array", "zeros", "invoke"]


def _to_tensor(data, ctx, dtype):
    if isinstance(data, torch.Tensor):
        device = ctx.torch_device() if ctx is not None else data.device
        return data.to(device=device,
                       dtype=canonical_dtype(dtype) if dtype else data.dtype)
    device = (ctx or current_context()).torch_device()
    arr = _np.ascontiguousarray(data)
    t = torch.from_numpy(arr)
    return t.to(device=device,
                dtype=canonical_dtype(dtype) if dtype else t.dtype)


class NDArray:
    """An n-dimensional array on one device."""

    __slots__ = ("_data",)

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor) or ctx is not None \
                or dtype is not None:
            data = _to_tensor(data, ctx, dtype)
        self._data = data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self._data.dtype

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self) -> Context:
        return Context.from_device(self._data.device)

    ctx = context

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return f"\n{self.asnumpy()}\n<NDArray {self.shape} @{self.context}>"

    def asnumpy(self) -> _np.ndarray:
        """Copy to host (waits for the device); bfloat16 widens to
        float32."""
        t = self._data.detach()
        return t.to("cpu", dtype=canonical_dtype(numpy_dtype(t.dtype))).numpy()

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self.context:
            return self
        return NDArray(self._data.to(ctx.torch_device()))

    def astype(self, dtype) -> "NDArray":
        return NDArray(self._data.to(canonical_dtype(dtype)))

    def _rebind(self, tensor):
        """Swap the underlying tensor (the mutation primitive)."""
        self._data = tensor

    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data
        return NDArray(self._data[key])

    def __add__(self, other):
        if isinstance(other, NDArray):
            other = other._data
        return NDArray(self._data + other)

    __radd__ = __add__


def _invoke(op_name, nd_inputs, kwargs):
    out = _reg.get(op_name)(*[x._data for x in nd_inputs], **kwargs)
    if isinstance(out, (tuple, list)):
        return tuple(NDArray(o) for o in out)
    return NDArray(out)


def invoke(op_name, *nd_inputs, **kwargs):
    """Generic op invocation: ``nd.invoke("slice_axis", x, axis=1, ...)``."""
    return _invoke(op_name, list(nd_inputs), kwargs)


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """An array from host data. The dtype is the source's for a numpy
    array or NDArray, float32 for Python lists and scalars."""
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    elif not isinstance(source_array, _np.ndarray) and dtype is None:
        dtype = "float32"
    return NDArray(_np.asarray(source_array), ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=None) -> NDArray:
    device = (ctx or current_context()).torch_device()
    return NDArray(torch.zeros(shape, dtype=canonical_dtype(dtype),
                               device=device))
