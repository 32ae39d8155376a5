"""``mx.library``: operator libraries loaded at run time.

Counterpart of ``mxnet_tpu/library.py`` (MXNet 1.x
``python/mxnet/library.py`` ``load``). A compiled library (``.so``)
exports the C ABI that the JAX package documents
(``mxnet_tpu/library.py:18-40``)::

    int         mxtpu_lib_version(void);           // must return 1
    int         mxtpu_lib_num_ops(void);
    const char *mxtpu_lib_op_name(int op_idx);
    // dtype codes: 0=float32 1=float64 2=int32 3=int64
    int mxtpu_lib_op_infer_shape(int op_idx, int num_in,
                                 const int64_t **in_shapes,
                                 const int *in_ndims,
                                 int64_t *out_shape /* cap 8 */,
                                 int *out_ndim);
    int mxtpu_lib_op_forward(int op_idx, int num_in,
                             const void **in, const int64_t **in_shapes,
                             const int *in_ndims, int dtype,
                             void *out, const int64_t *out_shape,
                             int out_ndim);

and each of its ops is registered under its exported name
(``mx.nd.<name>``, ``mx.sym.<name>``); a Python file (``.py``) is run
and registers ops itself (``mx.operator.register`` or
``ops.registry.register``). Entry points return 0 on success.

A loaded op runs on host memory, as in the JAX package: its inputs are
copied to the host, the library computes into a host buffer, and the
result is copied to the inputs' device. It is non-differentiable (the
ABI has no backward) and a host op (``registry.register(host=True)``):
a hybridized block or an executor that calls it runs uncaptured, counted
under its reason in ``compile.stats()``.
"""
from __future__ import annotations

import ctypes
import os
import runpy
import sys

import torch

__all__ = ["load", "loaded_libraries"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
                torch.int64: 3}
_MAX_NDIM = 8
_ABI = ("mxtpu_lib_version", "mxtpu_lib_num_ops", "mxtpu_lib_op_name",
        "mxtpu_lib_op_infer_shape", "mxtpu_lib_op_forward")
_LOADED = {}


def loaded_libraries():
    """Paths of every library loaded in this process."""
    return list(_LOADED)


def _shape_args(shapes):
    """ctypes arrays of the shapes, the pointers to them and the ranks
    (the first kept alive by the caller while the library reads it)."""
    arrays = [(ctypes.c_int64 * max(len(s), 1))(*s) for s in shapes]
    ptrs = (ctypes.POINTER(ctypes.c_int64) * len(shapes))(
        *[ctypes.cast(a, ctypes.POINTER(ctypes.c_int64)) for a in arrays])
    ndims = (ctypes.c_int * len(shapes))(*[len(s) for s in shapes])
    return arrays, ptrs, ndims


def _declare(lib):
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.mxtpu_lib_version.argtypes = []
    lib.mxtpu_lib_version.restype = ctypes.c_int
    lib.mxtpu_lib_num_ops.argtypes = []
    lib.mxtpu_lib_num_ops.restype = ctypes.c_int
    lib.mxtpu_lib_op_name.argtypes = [ctypes.c_int]
    lib.mxtpu_lib_op_name.restype = ctypes.c_char_p
    lib.mxtpu_lib_op_infer_shape.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(i64p),
        ctypes.POINTER(ctypes.c_int), i64p, ctypes.POINTER(ctypes.c_int)]
    lib.mxtpu_lib_op_infer_shape.restype = ctypes.c_int
    lib.mxtpu_lib_op_forward.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(i64p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_void_p, i64p, ctypes.c_int]
    lib.mxtpu_lib_op_forward.restype = ctypes.c_int


def _infer_shape(lib, idx, name, in_shapes):
    _keep, ptrs, ndims = _shape_args(in_shapes)
    out_shape = (ctypes.c_int64 * _MAX_NDIM)()
    out_ndim = ctypes.c_int()
    rc = lib.mxtpu_lib_op_infer_shape(idx, len(in_shapes), ptrs, ndims,
                                      out_shape, ctypes.byref(out_ndim))
    if rc != 0 or not 0 <= out_ndim.value <= _MAX_NDIM:
        raise RuntimeError(f"extension op {name!r}: infer_shape of "
                           f"{in_shapes} failed with code {rc}")
    return tuple(out_shape[i] for i in range(out_ndim.value))


def _host_call(lib, idx, name, arrays):
    """The library's forward on host copies of ``arrays``; its output
    on the first input's device."""
    dtype = arrays[0].dtype
    code = _DTYPE_CODES.get(dtype)
    if code is None or any(a.dtype != dtype for a in arrays):
        raise TypeError(f"extension op {name!r}: inputs of "
                        f"{[a.dtype for a in arrays]}; one of "
                        f"{sorted(map(str, _DTYPE_CODES))} is taken")
    shapes = [tuple(a.shape) for a in arrays]
    out_shape = _infer_shape(lib, idx, name, shapes)
    if arrays[0].device.type == "meta":   # the symbol layer's inference
        return torch.empty(out_shape, dtype=dtype, device="meta")
    host = [a.detach().to("cpu").contiguous() for a in arrays]
    out = torch.empty(out_shape, dtype=dtype)
    _keep, ptrs, ndims = _shape_args(shapes)
    ins = (ctypes.c_void_p * len(host))(*[a.data_ptr() for a in host])
    oshape = (ctypes.c_int64 * max(len(out_shape), 1))(*out_shape)
    rc = lib.mxtpu_lib_op_forward(
        idx, len(host), ins, ptrs, ndims, code,
        ctypes.c_void_p(out.data_ptr()), oshape, len(out_shape))
    if rc != 0:
        raise RuntimeError(f"extension op {name!r}: forward failed with "
                           f"code {rc}")
    return out.to(arrays[0].device)


def _register_lib_op(lib, idx, name):
    from .ops import registry

    def ext_op(*arrays):
        if not arrays:
            raise TypeError(f"extension op {name!r} needs an input")
        return _host_call(lib, idx, name, arrays)

    ext_op.__name__ = ext_op.__qualname__ = name
    ext_op.__doc__ = f"Extension op {name!r}, loaded by mx.library.load."
    registry.register(name, differentiable=False, host=True)(ext_op)


def _expose_ops(names):
    """``mx.nd.<name>`` and ``mx.sym.<name>`` for ops registered after
    those modules made their wrappers."""
    for mod_name in (__package__ + ".ndarray", __package__ + ".symbol"):
        mod = sys.modules.get(mod_name)
        if mod is None:
            continue
        for name in names:
            if not hasattr(mod, name):
                setattr(mod, name, mod._make_wrapper(name, name))


def load(path, verbose=True):
    """Load the operator library at ``path``: a compiled ``.so`` with the
    ABI above (each op registered under its exported name), or a ``.py``
    file that registers ops when it runs. Returns ``{"handle", "ops"}``
    for a library, the file's namespace for a ``.py``; a second load of
    one path returns the first's."""
    path = os.path.abspath(path)
    if not os.path.exists(path):
        raise ValueError(f"library {path!r} does not exist")
    if path in _LOADED:
        return _LOADED[path]
    from .ops import registry

    if path.endswith(".py"):
        before = set(registry.list_ops())
        ns = runpy.run_path(path)
        _expose_ops(sorted(set(registry.list_ops()) - before))
        _LOADED[path] = ns
        return ns
    lib = ctypes.CDLL(path)
    missing = [s for s in _ABI if not hasattr(lib, s)]
    if missing:
        raise ValueError(f"{path!r} is not an mxtpu extension library "
                         f"(missing {missing})")
    _declare(lib)
    version = lib.mxtpu_lib_version()
    if version != 1:
        raise ValueError(f"extension ABI version {version} unsupported")
    names = []
    for idx in range(lib.mxtpu_lib_num_ops()):
        name = lib.mxtpu_lib_op_name(idx).decode()
        _register_lib_op(lib, idx, name)
        names.append(name)
        if verbose:
            import logging

            logging.getLogger("mxnet_tpu_torch").info(
                "loaded extension op %s", name)
    _expose_ops(names)
    _LOADED[path] = {"handle": lib, "ops": names}
    return _LOADED[path]
