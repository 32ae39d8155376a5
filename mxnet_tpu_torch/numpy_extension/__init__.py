"""mx.npx: the operators beside NumPy's that neural networks need.

Counterpart of ``mxnet_tpu/numpy_extension/__init__.py`` (MXNet 1.x
``python/mxnet/numpy_extension/``). These run the registry's layer ops
(``FullyConnected``, ``Convolution``, ``BatchNorm``, ...) and return
``mx.np.ndarray``, so a model written in ``mx.np`` reaches the same
kernels as one written in ``mx.nd``. The module also holds the
NumPy-semantics switches (``set_np``/``reset_np``/``is_np_array``),
``save``/``load`` in the ``nd.save`` file format that return
``mx.np.ndarray``, ``waitall``, ``seed`` and the context helpers.

``softmax(length=)`` masks each row past its length, as MXNet 1.x's
``use_length=True`` does; the JAX package drops ``length`` (ROADMAP
C33). ``dropout`` draws from ``mx.random``'s generator of the data's
device in train mode, as ``nd.Dropout`` does.
"""
from __future__ import annotations

from .. import numpy as _np_mod
from ..ndarray.ndarray import _invoke
from ..numpy import ndarray
from ..util import (is_np_array, is_np_shape, reset_np, set_np,  # noqa: F401
                    use_np, use_np_array, use_np_shape)

__all__ = ["set_np", "reset_np", "is_np_array", "is_np_shape", "use_np",
           "relu", "sigmoid", "softmax", "log_softmax", "activation",
           "fully_connected", "convolution", "pooling", "batch_norm",
           "layer_norm", "dropout", "embedding", "one_hot", "pick", "topk",
           "rnn", "gamma", "erf", "erfinv", "reshape_like", "batch_dot",
           "gelu", "leaky_relu", "arange_like", "sequence_mask", "save",
           "load", "waitall", "seed", "cpu", "gpu", "num_gpus"]


def _np(op_name, *arrays, **kwargs):
    return _invoke(op_name, [_np_mod._as_np(a) for a in arrays], kwargs,
                   wrap=ndarray)


def relu(data):
    return _np("relu", data)


def sigmoid(data):
    return _np("sigmoid", data)


def gelu(data):
    return _np("LeakyReLU", data, act_type="gelu")


def leaky_relu(data, act_type="leaky", slope=0.25):
    return _np("LeakyReLU", data, act_type=act_type, slope=slope)


def activation(data, act_type="relu"):
    return _np("Activation", data, act_type=act_type)


def softmax(data, axis=-1, length=None, temperature=None):
    """Softmax over ``axis``; with ``length`` (one length per row, the
    shape of ``data`` without ``axis``) the positions past each length
    get 0, as MXNet 1.x's ``use_length=True``."""
    kwargs = {"axis": axis}
    if temperature is not None:
        kwargs["temperature"] = temperature
    if length is None:
        return _np("softmax", data, **kwargs)
    data = _np_mod._as_np(data)
    kwargs["length"] = _np_mod._as_np(length, ctx=data.context)._data
    return _np("softmax", data, use_length=True, **kwargs)


def log_softmax(data, axis=-1, temperature=None):
    kwargs = {"axis": axis}
    if temperature is not None:
        kwargs["temperature"] = temperature
    return _np("log_softmax", data, **kwargs)


def fully_connected(x, weight, bias=None, num_hidden=1, no_bias=False,
                    flatten=True):
    args = [x, weight] + ([] if bias is None else [bias])
    return _np("FullyConnected", *args, num_hidden=num_hidden,
               no_bias=bias is None or no_bias, flatten=flatten)


def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=1, num_group=1, no_bias=False):
    args = [data, weight] + ([] if bias is None else [bias])
    return _np("Convolution", *args, kernel=kernel, stride=stride,
               dilate=dilate, pad=pad, num_filter=num_filter,
               num_group=num_group, no_bias=bias is None or no_bias)


def pooling(data, kernel=(), stride=(), pad=(), pool_type="max",
            global_pool=False):
    return _np("Pooling", data, kernel=kernel, stride=stride, pad=pad,
               pool_type=pool_type, global_pool=global_pool)


def batch_norm(x, gamma, beta, running_mean, running_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               axis=1, training=False):
    return _np("BatchNorm", x, gamma, beta, running_mean, running_var,
               eps=eps, momentum=momentum, fix_gamma=fix_gamma,
               use_global_stats=use_global_stats, axis=axis,
               training=training)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    return _np("LayerNorm", data, gamma, beta, axis=axis, eps=eps)


def dropout(data, p=0.5, training=None, axes=(), **kwargs):
    """Dropout in train mode (``autograd.is_training()`` unless
    ``training`` says), the mask drawn from ``mx.random``'s generator of
    the data's device."""
    from .. import autograd
    from .. import random as _random

    data = _np_mod._as_np(data)
    training = autograd.is_training() if training is None else training
    if not training or p <= 0:
        return _np("_np_copy", data)
    return _np("Dropout", data, p=p, axes=tuple(axes), training=True,
               generator=_random.generator(data._data.device))


def embedding(data, weight, input_dim=1, output_dim=1, dtype="float32",
              sparse_grad=False):
    return _np("Embedding", data, weight, input_dim=input_dim,
               output_dim=output_dim, dtype=dtype)


def one_hot(data, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    return _np("one_hot", data, depth=depth, on_value=on_value,
               off_value=off_value, dtype=dtype)


def pick(data, index, axis=-1, mode="clip", keepdims=False):
    return _np("pick", data, index, axis=axis, mode=mode, keepdims=keepdims)


def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    return _np("topk", data, axis=axis, k=k, ret_typ=ret_typ,
               is_ascend=is_ascend, dtype=dtype)


def rnn(data, parameters, state, state_cell=None, mode="lstm",
        state_size=1, num_layers=1, bidirectional=False, p=0.0,
        state_outputs=False):
    args = [data, parameters, state] + \
        ([state_cell] if state_cell is not None else [])
    return _np("RNN", *args, mode=mode, state_size=state_size,
               num_layers=num_layers, bidirectional=bidirectional, p=p,
               state_outputs=state_outputs)


def gamma(data):
    return _np("gamma", data)


def erf(data):
    return _np("erf", data)


def erfinv(data):
    return _np("erfinv", data)


def reshape_like(lhs, rhs):
    return _np("reshape_like", lhs, rhs)


def batch_dot(a, b, transpose_a=False, transpose_b=False):
    return _np("batch_dot", a, b, transpose_a=transpose_a,
               transpose_b=transpose_b)


def arange_like(data, start=0.0, step=1.0, axis=None):
    """``start + step * i`` (float32) for ``i`` along ``axis``, or over
    every element when ``axis`` is None."""
    import torch

    from ..ndarray.ndarray import _invoke_fn

    def _al(x):
        n = x.shape[axis] if axis is not None else x.numel()
        return start + step * torch.arange(n, dtype=torch.float32,
                                           device=x.device)

    return _invoke_fn(_al, [_np_mod._as_np(data)], wrap=ndarray)


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    args = [data] + ([sequence_length] if sequence_length is not None else [])
    return _np("SequenceMask", *args,
               use_sequence_length=use_sequence_length, value=value,
               axis=axis)


def save(file, arr):
    """Save arrays in the ``nd.save`` format (either package reads it)."""
    from ..ndarray import utils as nd_utils

    nd_utils.save(file, arr)


def load(file):
    """Load an ``nd.save`` file; the values come back as
    ``mx.np.ndarray``."""
    from ..ndarray import utils as nd_utils

    loaded = nd_utils.load(file)
    if isinstance(loaded, dict):
        return {k: ndarray(v._data) for k, v in loaded.items()}
    if isinstance(loaded, list):
        return [ndarray(v._data) for v in loaded]
    return ndarray(loaded._data)


def waitall():
    from ..ndarray import waitall as _w

    _w()


def seed(seed_value):
    from .. import random as _r

    _r.seed(seed_value)


def cpu(device_id=0):
    from ..context import cpu as _cpu

    return _cpu(device_id)


def gpu(device_id=0):
    from ..context import gpu as _gpu

    return _gpu(device_id)


def num_gpus():
    from ..context import num_gpus as _n

    return _n()
