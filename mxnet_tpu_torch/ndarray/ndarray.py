"""NDArray: a thin handle over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``. The handle owns one
tensor, ``_data``; mutation is by rebinding that tensor (README
"Design"), so a Parameter's handle can be given new values without
callers holding stale references. Placement is explicit: an array lives
where its Context says, the card by default.

Operators and methods go through the registered ops (``ops/math.py``,
``ops/tensor.py``), as the JAX package's do: ``+ - * / % **`` with an
array (broadcast) or a Python number (the ``_*_scalar`` ops), their
reflected and in-place forms (in place rebinds, as there), comparisons
returning 1/0 in the input's dtype, ``//`` (floor division), and the
reduction, ordering, shape and indexing methods of
``mxnet_tpu/ndarray/ndarray.py:72-770``. Gradients flow through them
under ``autograd.record()``. ``attach_grad`` / ``grad`` / ``backward``
mirror MXNet's imperative autograd over ``torch.autograd``
(``mxnet_tpu_torch.autograd``).

The module functions are ``array``, ``zeros``, ``ones``, ``full``,
``empty``, ``arange`` (float32 by default, with ``repeat``), ``eye``,
``zeros_like``, ``ones_like``, ``concat``, ``stack``, ``split``,
``moveaxis``, ``dot``, ``waitall`` and ``invoke``; creation functions
take ``ctx``, default ``current_context()`` (the card).

``stype`` is ``"default"`` for a dense array and ``tostype`` converts
through ``sparse.cast_storage`` (``ndarray/sparse.py`` holds the
row-sparse and CSR subclasses). ``as_np_ndarray``/``as_nd_ndarray``
move between the frontends on the same tensor; an op with an
``mx.np.ndarray`` input returns one (``_invoke``'s ``wrap``). Left out:
``__reduce__``
(pickling; ``nd.save`` is the port's format) and ``asnumpy_or_self``.
"""
from __future__ import annotations

import numbers

import numpy as _np
import torch

from .. import _amp_core
from .. import faults as _faults
from .. import profiler as _profiler
from .. import watchdog as _watchdog
from ..base import canonical_dtype, numpy_dtype
from ..context import Context, current_context
from ..ops import registry as _reg

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "eye", "zeros_like", "ones_like", "concat", "stack", "split",
           "moveaxis", "dot", "waitall", "invoke"]


def _to_tensor(data, ctx, dtype):
    if isinstance(data, torch.Tensor):
        device = ctx.torch_device() if ctx is not None else data.device
        return data.to(device=device,
                       dtype=canonical_dtype(dtype) if dtype else data.dtype)
    device = (ctx or current_context()).torch_device()
    arr = _np.ascontiguousarray(data).reshape(_np.shape(data))
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
    # mx.np.ndarray sets it: an op with such an input returns that class
    _np_frontend = False

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

    @property
    def stype(self):
        """The storage type: ``"default"`` (dense)."""
        return "default"

    def tostype(self, stype):
        """This array in storage ``stype`` (``"default"``: itself)."""
        if stype == "default":
            return self
        from .sparse import cast_storage

        return cast_storage(self, stype)

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return f"\n{self.asnumpy()}\n<NDArray {self.shape} @{self.context}>"

    def asnumpy(self) -> _np.ndarray:
        """Copy to host (waits for the device); bfloat16 widens to
        float32. A copy on the CPU too: later updates in place do not show
        through. Hits the ``host.sync`` fault point first (JAX
        ``_bounded_block``, :224)."""
        if _faults.ARMED:
            _faults.point("host.sync")
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
        synchronise on a card), after the ``host.sync`` fault point; both
        under a ``host.sync`` watchdog deadline when one is armed (JAX
        ``_bounded_block``, :215-227), so a wedge raises a catchable
        ``StallError``."""
        device = self._data.device

        def block():
            if _faults.ARMED:
                _faults.point("host.sync")
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        _watchdog.sync("host.sync", block, label="wait_to_read")

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self.context:
            return self
        return self._like(self._data.to(ctx.torch_device()))

    as_in_ctx = as_in_context

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

    def astype(self, dtype, copy=True) -> "NDArray":
        return _invoke("Cast", [self], {"dtype": dtype})

    def copy(self) -> "NDArray":
        return _invoke("copy", [self], {})

    def detach(self) -> "NDArray":
        return self._like(self._data.detach())

    def item(self):
        return self.asscalar()

    def wait_to_write(self):
        self.wait_to_read()

    def to_device(self, ctx):
        return self.as_in_context(ctx)

    def as_np_ndarray(self):
        """This array as an ``mx.np.ndarray`` (the same tensor)."""
        from ..numpy import ndarray

        return ndarray(self._data)

    def as_nd_ndarray(self):
        """This array as a legacy NDArray (the same tensor)."""
        return NDArray(self._data)

    def _like(self, tensor):
        """``tensor`` in this array's frontend class (mx.np or NDArray)."""
        return type(self)(tensor) if self._np_frontend else NDArray(tensor)

    def _rebind(self, tensor):
        """Swap the underlying tensor (the mutation primitive)."""
        self._data = tensor

    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data
        return self._like(self._data[key])

    def __setitem__(self, key, value):
        """``x[key] = value``: the array is rebound to a copy with the
        slice written (values cast to its dtype), as the JAX package's
        functional update; a value of another shape broadcasts."""
        if isinstance(key, NDArray):
            key = key._data
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(_np.asarray(value))
        value = value.to(device=self._data.device, dtype=self._data.dtype)
        new = self._data.clone()
        new[key] = value
        self._rebind(new)

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self.asnumpy().item())

    def __int__(self):
        return int(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __hash__(self):
        return id(self)

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

    # ----------------------------------------------------- arithmetic -----
    def _binary(self, other, op, reverse=False):
        """``op`` (a broadcast op's name) with ``other``: an NDArray or a
        numpy array (broadcast), or a Python number (the matching
        ``_*_scalar`` op)."""
        if isinstance(other, numbers.Number):
            fwd, rev = _SCALAR_OPS[op]
            return _invoke(rev if reverse else fwd, [self],
                           {"scalar": other})
        if isinstance(other, _np.ndarray):
            other = NDArray(other, ctx=self.context)
        if not isinstance(other, NDArray):
            return NotImplemented
        return _invoke(op, [other, self] if reverse else [self, other], {})

    def __add__(self, other):
        return self._binary(other, "broadcast_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "broadcast_sub")

    def __rsub__(self, other):
        return self._binary(other, "broadcast_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "broadcast_div")

    def __rtruediv__(self, other):
        return self._binary(other, "broadcast_div", reverse=True)

    def __floordiv__(self, other):
        return self._floordiv(other, False)

    def __rfloordiv__(self, other):
        return self._floordiv(other, True)

    def _floordiv(self, other, reverse):
        """``floor(a / b)`` (MXNet's NDArray has no ``//``; this is
        Python's, in the promoted dtype)."""
        if isinstance(other, NDArray):
            other = other._data
        elif isinstance(other, _np.ndarray):
            other = NDArray(other, ctx=self.context)._data
        elif not isinstance(other, numbers.Number):
            return NotImplemented
        a, b = (other, self._data) if reverse else (self._data, other)
        if isinstance(a, numbers.Number):
            a = torch.full((), a, dtype=torch.result_type(b, a),
                           device=b.device)
        return NDArray(torch.div(a, b, rounding_mode="floor"))

    def __mod__(self, other):
        return self._binary(other, "broadcast_mod")

    def __rmod__(self, other):
        return self._binary(other, "broadcast_mod", reverse=True)

    def __pow__(self, other):
        return self._binary(other, "broadcast_power")

    def __rpow__(self, other):
        return self._binary(other, "broadcast_power", reverse=True)

    def __neg__(self):
        return _invoke("negative", [self], {})

    def __abs__(self):
        return _invoke("abs", [self], {})

    def __eq__(self, other):
        return self._binary(other, "broadcast_equal")

    def __ne__(self, other):
        return self._binary(other, "broadcast_not_equal")

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal")

    def _inplace(self, other, op):
        """``op`` with ``other``, rebinding this array to the result
        (MXNet's in-place operators, as the JAX package's rebind)."""
        out = self._binary(other, op)
        if out is NotImplemented:
            return out
        self._rebind(out._data)
        return self

    def __iadd__(self, other):
        return self._inplace(other, "broadcast_add")

    def __isub__(self, other):
        return self._inplace(other, "broadcast_sub")

    def __imul__(self, other):
        return self._inplace(other, "broadcast_mul")

    def __itruediv__(self, other):
        return self._inplace(other, "broadcast_div")

    # -------------------------------------------------------- methods -----
    def reshape(self, *shape, **kwargs):
        shape = shape[0] if len(shape) == 1 and isinstance(
            shape[0], (tuple, list)) else shape
        shape = kwargs.get("shape", shape)
        return _invoke("reshape", [self], {"shape": tuple(shape)})

    def reshape_like(self, other):
        return _invoke("reshape_like", [self, other], {})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _invoke("transpose", [self], {"axes": tuple(axes)})

    @property
    def T(self):  # noqa: N802 - MXNet's name
        return self.transpose()

    def flatten(self):
        return _invoke("Flatten", [self], {})

    def expand_dims(self, axis):
        return _invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _invoke("squeeze", [self], {"axis": axis})

    def broadcast_to(self, shape):
        return _invoke("broadcast_to", [self], {"shape": tuple(shape)})

    def broadcast_like(self, other):
        return _invoke("broadcast_like", [self, other], {})

    def slice(self, begin, end, step=()):
        return _invoke("slice", [self], {"begin": tuple(begin),
                                         "end": tuple(end),
                                         "step": tuple(step)})

    def slice_axis(self, axis, begin, end):
        return _invoke("slice_axis", [self],
                       {"axis": axis, "begin": begin, "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return _invoke("take", [self, indices], {"axis": axis, "mode": mode})

    def one_hot(self, depth, **kwargs):
        return _invoke("one_hot", [self], {"depth": depth, **kwargs})

    def clip(self, a_min=None, a_max=None):
        return _invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def abs(self):
        return _invoke("abs", [self], {})

    def sign(self):
        return _invoke("sign", [self], {})

    def sqrt(self):
        return _invoke("sqrt", [self], {})

    def square(self):
        return _invoke("square", [self], {})

    def exp(self):
        return _invoke("exp", [self], {})

    def log(self):
        return _invoke("log", [self], {})

    def relu(self):
        return _invoke("relu", [self], {})

    def sigmoid(self):
        return _invoke("sigmoid", [self], {})

    def tanh(self):
        return _invoke("tanh", [self], {})

    def softmax(self, axis=-1):
        return _invoke("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return _invoke("log_softmax", [self], {"axis": axis})

    def _reduce(self, op, axis, keepdims):
        return _invoke(op, [self], {"axis": axis, "keepdims": keepdims})

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _invoke("norm", [self], {"ord": ord, "axis": axis,
                                        "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis, keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return _invoke("argsort", [self], {"axis": axis,
                                           "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return _invoke("sort", [self], {"axis": axis, "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return _invoke("topk", [self], {"axis": axis, "k": k,
                                        "ret_typ": ret_typ,
                                        "is_ascend": is_ascend})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _invoke("dot", [self, other], {"transpose_a": transpose_a,
                                              "transpose_b": transpose_b})

    def flip(self, axis):
        return _invoke("flip", [self], {"axis": axis})

    def tile(self, reps):
        return _invoke("tile", [self], {"reps": tuple(reps)})

    def repeat(self, repeats, axis=None):
        return _invoke("repeat", [self], {"repeats": repeats, "axis": axis})

    def pad(self, mode="constant", pad_width=(), constant_value=0.0):
        return _invoke("pad", [self], {"mode": mode,
                                       "pad_width": tuple(pad_width),
                                       "constant_value": constant_value})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _invoke("SliceChannel", [self],
                       {"num_outputs": num_outputs, "axis": axis,
                        "squeeze_axis": squeeze_axis})

    def swapaxes(self, dim1, dim2):
        return _invoke("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    def zeros_like(self):
        return _invoke("zeros_like", [self], {})

    def ones_like(self):
        return _invoke("ones_like", [self], {})

    # ------------------------------------------------------ autograd -----
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a leaf whose gradient ``backward`` fills:
        ``"write"`` overwrites it, ``"add"`` accumulates, ``"null"``
        detaches. ``stype`` is accepted and ignored, as by the JAX
        package: the gradient is dense."""
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
        return self._like(self._data.grad)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)


def _wrap_class(nd_inputs):
    """The output class of an op on ``nd_inputs``: ``mx.np.ndarray`` when
    one input is one (JAX :645-656), else NDArray; one attribute read an
    input."""
    for x in nd_inputs:
        if x._np_frontend:
            return type(x)
    return NDArray


def _invoke(op_name, nd_inputs, kwargs, wrap=None):
    """Run op ``op_name`` on the arrays' tensors. ``wrap`` is the output
    class (NDArray, or ``mx.np.ndarray`` for the NumPy frontend); by
    default the inputs' (:func:`_wrap_class`)."""
    # the op's schema: a misspelt keyword raises OpParamError here, and
    # dmlc strings are coerced (one frozen-key lookup once seen)
    kwargs = _reg.checked(op_name, kwargs)
    if wrap is None:
        wrap = _wrap_class(nd_inputs)
    prof_t0 = _profiler._now_us() if _profiler._REC_IMPERATIVE else None
    tensors = [x._data for x in nd_inputs]
    if _amp_core.ACTIVE:   # amp.init(): the op's AMP cast
        tensors = _amp_core.cast_inputs(_reg.canonical(op_name), tensors)
    out = _reg.get(op_name)(*tensors, **kwargs)
    out = tuple(wrap(o) for o in out) if isinstance(out, (tuple, list)) \
        else wrap(out)
    if prof_t0 is not None:
        _profiler.record_event(op_name, prof_t0,
                               _profiler._now_us() - prof_t0)
    return out


def _invoke_fn(fn, nd_inputs, wrap=None):
    """Run the function ``fn`` of tensors on the arrays' tensors as if it
    were an op (fancy indexing, frontend helpers; JAX ``_invoke_fn``,
    :724-731), with :func:`_invoke`'s output class."""
    if wrap is None:
        wrap = _wrap_class(nd_inputs)
    out = fn(*[x._data for x in nd_inputs])
    if isinstance(out, (tuple, list)):
        return tuple(wrap(o) for o in out)
    return wrap(out)


def invoke(op_name, *nd_inputs, **kwargs):
    """Generic op invocation: ``nd.invoke("slice_axis", x, axis=1, ...)``."""
    return _invoke(op_name, list(nd_inputs), kwargs)


# a broadcast op -> its scalar op, and the one for a number on the left
_SCALAR_OPS = {
    "broadcast_add": ("_plus_scalar", "_plus_scalar"),
    "broadcast_sub": ("_minus_scalar", "_rminus_scalar"),
    "broadcast_mul": ("_mul_scalar", "_mul_scalar"),
    "broadcast_div": ("_div_scalar", "_rdiv_scalar"),
    "broadcast_mod": ("_mod_scalar", "_rmod_scalar"),
    "broadcast_power": ("_power_scalar", "_rpower_scalar"),
    "broadcast_maximum": ("_maximum_scalar", "_maximum_scalar"),
    "broadcast_minimum": ("_minimum_scalar", "_minimum_scalar"),
    "broadcast_equal": ("_equal_scalar", "_equal_scalar"),
    "broadcast_not_equal": ("_not_equal_scalar", "_not_equal_scalar"),
    "broadcast_greater": ("_greater_scalar", "_lesser_scalar"),
    "broadcast_greater_equal": ("_greater_equal_scalar",
                                "_lesser_equal_scalar"),
    "broadcast_lesser": ("_lesser_scalar", "_greater_scalar"),
    "broadcast_lesser_equal": ("_lesser_equal_scalar",
                               "_greater_equal_scalar"),
}


# ------------------------------------------------------------ creation -----

def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _device(ctx):
    return (ctx or current_context()).torch_device()


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """An array from host data. The dtype is the source's for a numpy
    array or NDArray, float32 for Python lists and scalars."""
    if isinstance(source_array, NDArray):
        source_array = source_array.asnumpy()
    elif not isinstance(source_array, _np.ndarray) and dtype is None:
        dtype = "float32"
    return NDArray(_np.asarray(source_array), ctx=ctx, dtype=dtype)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    """An array of ``shape`` (zero-filled, as the JAX package's)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=canonical_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=canonical_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None) -> NDArray:
    return NDArray(torch.full(_shape(shape), val,
                              dtype=canonical_dtype(dtype),
                              device=_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    """``[start, stop)`` by ``step`` (float32 by default), each value
    ``repeat`` times."""
    return NDArray(_reg.get("_arange")(
        start=start, stop=stop, step=step, repeat=repeat,
        dtype=dtype or "float32", ctx=_device(ctx)))


def eye(N, M=0, k=0, ctx=None, dtype=None) -> NDArray:  # noqa: N803
    """Ones on the ``k``-th diagonal of an ``N`` x ``M`` (default ``N``)
    matrix."""
    m = M or N
    out = torch.zeros((N, m), dtype=canonical_dtype(dtype),
                      device=_device(ctx))
    torch.diagonal(out, offset=k).fill_(1)
    return NDArray(out)


def zeros_like(a) -> NDArray:
    return _invoke("zeros_like", [a], {})


def ones_like(a) -> NDArray:
    return _invoke("ones_like", [a], {})


def _arrays(args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        return list(args[0])
    return list(args)


def concat(*args, dim=1, **kwargs) -> NDArray:
    """Join arrays (given as arguments or one list) along ``dim``."""
    return _invoke("Concat", _arrays(args), {"dim": dim})


def stack(*args, axis=0, **kwargs) -> NDArray:
    """Stack arrays (given as arguments or one list) on a new ``axis``."""
    return _invoke("stack", _arrays(args), {"axis": axis})


def split(data, num_outputs, axis=1, squeeze_axis=False):
    return _invoke("SliceChannel", [data],
                   {"num_outputs": num_outputs, "axis": axis,
                    "squeeze_axis": squeeze_axis})


def moveaxis(a, source, destination) -> NDArray:
    return NDArray(torch.movedim(a._data, source, destination))


def dot(lhs, rhs, transpose_a=False, transpose_b=False) -> NDArray:
    return _invoke("dot", [lhs, rhs], {"transpose_a": transpose_a,
                                       "transpose_b": transpose_b})


def waitall():
    """Wait for the work queued on every card a context has resolved to
    (the JAX package's ``engine.wait_all``), under a ``host.sync``
    watchdog deadline when one is armed."""
    from ..context import _TOUCHED

    def block():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for index in sorted(_TOUCHED):
                torch.cuda.synchronize(index)

    _watchdog.sync("host.sync", block, label="waitall")
