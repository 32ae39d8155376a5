"""Utilities: the NumPy-semantics scopes and small helpers.

Counterpart of ``mxnet_tpu/util.py`` (MXNet 1.x ``python/mxnet/util.py``):
``set_np_shape`` :52, ``np_shape`` :161, ``np_array`` :354, ``use_np``
:488, ``set_np`` :676 switch the frontend into NumPy semantics, and
``is_np_array()`` makes Gluon blocks hand back ``mx.np.ndarray`` where
they were fed one. The flags are thread-local, as MXNet's are.
``getenv``/``setenv``, ``set_module``, ``default_array`` and
``wrap_data_api_statistical_func`` complete the module.
"""
from __future__ import annotations

import functools
import os
import threading

__all__ = ["set_np_shape", "is_np_shape", "np_shape", "use_np_shape",
           "np_array", "is_np_array", "use_np_array", "use_np", "set_np",
           "reset_np", "getenv", "setenv", "set_module",
           "default_array", "wrap_data_api_statistical_func"]

_tls = threading.local()


def _state():
    if not hasattr(_tls, "np_shape"):
        _tls.np_shape = False
        _tls.np_array = False
    return _tls


def set_np_shape(active):
    """Turn NumPy shape semantics on/off globally (parity: util.py:52).
    Returns the previous state."""
    st = _state()
    prev, st.np_shape = st.np_shape, bool(active)
    return prev


def is_np_shape():
    """parity: util.py:99."""
    return _state().np_shape


class _Scope:
    def __init__(self, getter_setter, active):
        self._set = getter_setter
        self._active = active
        self._prev = None

    def __enter__(self):
        self._prev = self._set(self._active)
        return self

    def __exit__(self, *exc):
        self._set(self._prev)


def np_shape(active=True):
    """Context manager scoping NumPy shape semantics (parity: :161)."""
    return _Scope(set_np_shape, active)


def use_np_shape(func):
    """Decorator running `func` under np_shape (parity: :230). Works on
    functions and classes (wraps all public methods)."""
    if isinstance(func, type):
        for name, attr in list(vars(func).items()):
            if callable(attr) and not name.startswith("__"):
                setattr(func, name, use_np_shape(attr))
        init = func.__init__
        func.__init__ = use_np_shape(init)
        return func

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with np_shape(True):
            return func(*args, **kwargs)

    return wrapper


def _set_np_array(active):
    st = _state()
    prev, st.np_array = st.np_array, bool(active)
    return prev


def np_array(active=True):
    """Context manager scoping mx.np array output semantics (parity: :354)."""
    return _Scope(_set_np_array, active)


def is_np_array():
    """parity: util.py:383."""
    return _state().np_array


def use_np_array(func):
    """parity: util.py:406."""
    if isinstance(func, type):
        for name, attr in list(vars(func).items()):
            if callable(attr) and not name.startswith("__"):
                setattr(func, name, use_np_array(attr))
        init = func.__init__
        func.__init__ = use_np_array(init)
        return func

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with np_array(True):
            return func(*args, **kwargs)

    return wrapper


def use_np(func):
    """Decorator = use_np_shape + use_np_array (parity: util.py:488)."""
    return use_np_shape(use_np_array(func))


def set_np(shape=True, array=True):
    """Globally activate NumPy semantics (parity: util.py:676)."""
    if not shape and array:
        raise ValueError("NumPy array semantics requires NumPy shape "
                         "semantics")
    set_np_shape(shape)
    _set_np_array(array)


def reset_np():
    """parity: util.py:755."""
    set_np(False, False)


def getenv(name):
    """parity: util.py:821 (MXGetEnv)."""
    return os.environ.get(name)


def setenv(name, value):
    """parity: util.py:839 (MXSetEnv)."""
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


def set_module(module):
    """Decorator overriding __module__ for doc rendering (parity: :311)."""

    def deco(obj):
        if module is not None:
            obj.__module__ = module
        return obj

    return deco


def default_array(source_array, ctx=None, dtype=None):
    """Create an NDArray or np ndarray per the active semantics."""
    if is_np_array():
        from . import numpy as _np_mod

        return _np_mod.array(source_array, ctx=ctx, dtype=dtype)
    from .ndarray import array

    return array(source_array, ctx=ctx, dtype=dtype)


def wrap_data_api_statistical_func(func):
    """Keyword-compat shim used by mx.np statistical funcs (parity:
    util.py wrap_data_api_statistical_func)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        return func(*args, **kwargs)

    return wrapper
