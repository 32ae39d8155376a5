"""NDArray: a thin handle over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``. The handle owns one
tensor, ``_data``; mutation is by rebinding that tensor (README
"Design"), so a Parameter's handle can be given new values without
callers holding stale references. Placement is explicit: an array lives
where its Context says, the card by default.

Arithmetic and reductions are the ones the loss and the trainer use
(``+ - *``, negation, ``sum``, ``mean``, ``reshape``); they act on the
tensors directly, so gradients flow through them under
``autograd.record()``. ``attach_grad`` / ``grad`` / ``backward`` mirror
MXNet's imperative autograd over ``torch.autograd``
(``mxnet_tpu_torch.autograd``).
"""
from __future__ import annotations

import numbers

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
    if not arr.flags.writeable:  # torch.from_numpy shares the buffer
        arr = arr.copy()
    t = torch.from_numpy(arr)
    # a copy on the CPU too, as MXNet's: updates in place (optimizers,
    # copyto, the kvstore) must not write into the caller's numpy array
    return t.to(device=device,
                dtype=canonical_dtype(dtype) if dtype else t.dtype,
                copy=True)


class NDArray:
    """An n-dimensional array on one device."""

    __slots__ = ("_data", "_grad_req")

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor) or ctx is not None \
                or dtype is not None:
            data = _to_tensor(data, ctx, dtype)
        self._data = data
        self._grad_req = "null"

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
        float32. A copy on the CPU too: later updates in place do not show
        through."""
        t = self._data.detach()
        return t.to("cpu", dtype=canonical_dtype(numpy_dtype(t.dtype)),
                    copy=True).numpy()

    def asscalar(self):
        """The value of a one-element array as a Python number."""
        if self.size != 1:
            raise ValueError(f"asscalar needs a one-element array, got "
                             f"shape {self.shape}")
        return self.asnumpy().item()

    def wait_to_read(self):
        """Block until the array's producers have finished (a device
        synchronise on a card)."""
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self.context:
            return self
        return NDArray(self._data.to(ctx.torch_device()))

    def copyto(self, other):
        """Copy the values into ``other``, an NDArray of the same shape,
        in place (its device and dtype stay), and return it; or onto a
        Context, as a new array."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True))
        if not isinstance(other, NDArray):
            raise TypeError(f"copyto target must be NDArray or Context, got "
                            f"{type(other)}")
        if other.shape != self.shape:
            raise ValueError(f"copyto: shape {self.shape} into "
                             f"{other.shape}")
        with torch.no_grad():
            other._data.copy_(self._data)
        return other

    def astype(self, dtype) -> "NDArray":
        return NDArray(self._data.to(canonical_dtype(dtype)))

    def _rebind(self, tensor):
        """Swap the underlying tensor (the mutation primitive)."""
        self._data = tensor

    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data
        return NDArray(self._data[key])

    def _binary(self, other, fn):
        if isinstance(other, NDArray):
            other = other._data
        elif not isinstance(other, numbers.Number):
            return NotImplemented
        return NDArray(fn(self._data, other))

    def __add__(self, other):
        return self._binary(other, torch.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, torch.sub)

    def __mul__(self, other):
        return self._binary(other, torch.mul)

    __rmul__ = __mul__

    def __neg__(self):
        return NDArray(-self._data)

    def _reduce(self, fn, axis, keepdims):
        if axis is None:
            out = fn(self._data)
            return NDArray(out.reshape((1,) * self.ndim) if keepdims else out)
        axis = (axis,) if isinstance(axis, int) else tuple(axis)
        return NDArray(fn(self._data, dim=axis, keepdim=keepdims))

    def sum(self, axis=None, keepdims=False):
        return self._reduce(torch.sum, axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce(torch.mean, axis, keepdims)

    def reshape(self, *shape):
        shape = shape[0] if len(shape) == 1 and isinstance(
            shape[0], (tuple, list)) else shape
        return NDArray(self._data.reshape(tuple(shape)))

    # ------------------------------------------------------ autograd -----
    def attach_grad(self, grad_req="write"):
        """Make this array a leaf whose gradient ``backward`` fills:
        ``"write"`` overwrites it, ``"add"`` accumulates, ``"null"``
        detaches."""
        if grad_req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be write, add or null, got "
                             f"{grad_req!r}")
        self._data = self._data.detach().requires_grad_(grad_req != "null")
        self._grad_req = grad_req
        if grad_req != "null":
            self._data._mx_grad_req = grad_req

    @property
    def grad(self):
        """The gradient buffer that ``backward`` writes into: zeros until
        the first backward, None without ``attach_grad``."""
        if not self._data.requires_grad:
            return None
        if self._data.grad is None:
            self._data.grad = torch.zeros_like(
                self._data, memory_format=torch.contiguous_format)
        return NDArray(self._data.grad)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)


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
