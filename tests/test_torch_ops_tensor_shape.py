"""The port's tensor ops (ops/tensor.py), second part: shape ops, index
arithmetic, the sequence ops, the creation ops and the rest, against the
JAX package's on the same numpy inputs (forward, and the gradient under
``autograd.record()`` against ``jax.vjp`` for differentiable ops;
float32 rtol=1e-5, atol=1e-6; integer-valued outputs exactly). The
reductions, ordering, products, indexing and the registry's coverage are
in ``tests/test_torch_ops_tensor.py``."""
import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from test_torch_ops_math import CPU, _rand, check


# ---------------------------------------------------------- shape ops -----

SHAPE = [
    ("reshape_like", [_rand(2, 6), _rand(3, 4)], {}, (0,)),
    ("expand_dims", [_rand(2, 3)], {"axis": 1}, (0,)),
    ("expand_dims", [_rand(2, 3)], {"axis": -1}, (0,)),
    ("squeeze", [_rand(2, 1, 3, 1)], {}, (0,)),
    ("squeeze", [_rand(2, 1, 3, 1)], {"axis": (1, 3)}, (0,)),
    ("Concat", [_rand(2, 3), _rand(2, 4, seed=1), _rand(2, 1, seed=2)],
     {}, (0, 1, 2)),
    ("concat", [_rand(2, 3), _rand(4, 3, seed=1)], {"dim": 0}, (0, 1)),
    ("stack", [_rand(2, 3), _rand(2, 3, seed=1)], {"axis": 1}, (0, 1)),
    ("SliceChannel", [_rand(2, 6, 3)], {"num_outputs": 3}, (0,)),
    ("split", [_rand(2, 6, 3)], {"num_outputs": 2, "axis": 2 - 2}, ()),
    ("slice_channel", [_rand(2, 6, 3)], {"num_outputs": 3, "axis": 2,
                                         "squeeze_axis": True}, (0,)),
    ("SliceChannel", [_rand(2, 6, 3)], {"num_outputs": 1}, (0,)),
    ("split_v2", [_rand(7, 3)], {"indices": (2, 5)}, (0,)),
    ("split_v2", [_rand(7, 3)], {"indices": (0, 2, 5)}, (0,)),
    ("_split_v2", [_rand(3, 6)], {"sections": 3, "axis": 1}, (0,)),
    ("split_v2", [_rand(3, 6)], {"sections": 3, "axis": 1,
                                 "squeeze_axis": False}, ()),
    ("slice", [_rand(4, 5, 6)], {"begin": (1, None, 0), "end": (3, 4, None),
                                 "step": (1, 2, 3)}, (0,)),
    ("slice", [_rand(4, 5, 6)], {"begin": (None, 4), "end": (None, 0),
                                 "step": (None, -2)}, (0,)),
    ("slice", [_rand(4, 5)], {"begin": (-1,), "end": (None,),
                              "step": (-1,)}, (0,)),
    ("slice_axis", [_rand(4, 5)], {"axis": 1, "begin": 1, "end": 4}, (0,)),
    ("slice_like", [_rand(4, 5, 6), _rand(2, 3, 4)], {"axes": (0, 2)},
     (0,)),
    ("slice_like", [_rand(4, 5), _rand(2, 3)], {}, (0,)),
    ("flip", [_rand(3, 4)], {"axis": 1}, (0,)),
    ("reverse", [_rand(3, 4)], {"axis": (0, 1)}, (0,)),
    ("tile", [_rand(2, 3)], {"reps": (2, 1, 3)}, (0,)),
    ("tile", [_rand(2, 3)], {"reps": (2,)}, (0,)),
    ("repeat", [_rand(2, 3)], {"repeats": 2}, (0,)),
    ("repeat", [_rand(2, 3)], {"repeats": 3, "axis": 1}, (0,)),
    ("pad", [_rand(1, 2, 3, 4)], {"pad_width": (0, 0, 0, 0, 1, 2, 2, 1)},
     (0,)),
    ("Pad", [_rand(1, 2, 3, 4)], {"mode": "constant",
                                  "pad_width": (0, 0, 1, 0, 1, 1, 0, 2),
                                  "constant_value": 1.5}, (0,)),
    ("pad", [_rand(1, 2, 4, 5)], {"mode": "edge",
                                  "pad_width": (0, 0, 0, 0, 2, 1, 1, 2)},
     (0,)),
    ("pad", [_rand(2, 2, 4, 5)], {"mode": "reflect",
                                  "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)},
     (0,)),
    ("pad", [_rand(1, 2, 3, 4, 5)], {"mode": "edge",
                                     "pad_width": (0, 0, 0, 0, 1, 1, 0, 0,
                                                   2, 2)}, (0,)),
    ("swapaxes", [_rand(2, 3, 4)], {"dim1": 0, "dim2": 2}, (0,)),
    ("SwapAxis", [_rand(2, 3, 4)], {"dim1": 1, "dim2": 2}, (0,)),
    ("depth_to_space", [_rand(1, 8, 2, 3)], {"block_size": 2}, (0,)),
    ("space_to_depth", [_rand(1, 2, 4, 6)], {"block_size": 2}, (0,)),
    ("diag", [_rand(4)], {}, (0,)),
    ("diag", [_rand(4)], {"k": -1}, (0,)),
    ("diag", [_rand(3, 4)], {"k": 1}, (0,)),
    ("diag", [_rand(2, 3, 4)], {"axis1": 1, "axis2": 2}, (0,)),
    ("reshape", [_rand(2, 3, 4)], {"shape": (0, -1)}, (0,)),
    ("transpose", [_rand(2, 3, 4)], {"axes": (2, 0, 1)}, (0,)),
    ("Flatten", [_rand(2, 3, 4)], {}, (0,)),
]


@pytest.mark.parametrize("case", SHAPE, ids=lambda c: c[0])
def test_shape_ops(case):
    name, arrays, kw, argnums = case
    check(name, arrays, kw, argnums=argnums)


def test_shape_and_size_arrays_are_int64():
    """MXNet's int64; the JAX package asks for int64 and, with x64 off,
    gets int32: the values are held equal."""
    x = _rand(2, 3, 4)
    for name, want in (("shape_array", [2, 3, 4]), ("size_array", [24])):
        with CPU:
            got = mx.nd.invoke(name, mx.nd.array(x)).asnumpy()
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(jreg.get(name).fn(x), want)


INDEX_MATH = [
    ("unravel_index", [np.array([0, 5, 11, 13, -1], np.float32)],
     {"shape": (3, 4)}),
    ("_unravel_index", [np.array([7, 2], np.float32)], {"shape": (2, 2, 2)}),
    ("ravel_multi_index", [np.array([[0, 2, 1, 5], [3, 0, 1, -1]],
                                    np.float32)], {"shape": (3, 4)}),
    ("_ravel_multi_index", [np.array([[1, 0], [1, 1], [0, 1]],
                                     np.float32)], {"shape": (2, 2, 2)}),
]


@pytest.mark.parametrize("case", INDEX_MATH, ids=lambda c: c[0])
def test_index_arithmetic(case):
    name, arrays, kw = case
    check(name, arrays, kw)


def test_split_needs_an_equal_division():
    with CPU, pytest.raises(ValueError, match="equal division"):
        mx.nd.split(mx.nd.array(_rand(2, 5)), 2)


# ------------------------------------------------------------- sequence ---

LENGTHS = np.array([2, 4, 1], np.float32)
SEQUENCE = [
    ("SequenceMask", [_rand(4, 3, 2), LENGTHS], {}, (0,)),
    ("SequenceMask", [_rand(4, 3, 2), LENGTHS],
     {"use_sequence_length": True, "value": -1.0}, (0,)),
    ("sequence_mask", [_rand(3, 4, 2), LENGTHS],
     {"use_sequence_length": True, "axis": 1}, (0,)),
    ("SequenceLast", [_rand(4, 3, 2), LENGTHS], {}, (0,)),
    ("SequenceLast", [_rand(4, 3, 2), LENGTHS],
     {"use_sequence_length": True}, (0,)),
    ("sequence_last", [_rand(3, 4, 2), LENGTHS],
     {"use_sequence_length": True, "axis": 1}, (0,)),
    ("SequenceReverse", [_rand(4, 3, 2), LENGTHS], {}, (0,)),
    ("SequenceReverse", [_rand(4, 3, 2), LENGTHS],
     {"use_sequence_length": True}, (0,)),
    ("sequence_reverse", [_rand(4, 3), LENGTHS],
     {"use_sequence_length": True}, (0,)),
]


@pytest.mark.parametrize("case", SEQUENCE, ids=lambda c: c[0])
def test_sequence_ops(case):
    name, arrays, kw, argnums = case
    check(name, arrays, kw, argnums=argnums)


# ------------------------------------------------------------- creation ---

CREATION = [
    ("_zeros", {"shape": (2, 3)}), ("_zeros_without_dtype", {"shape": (4,)}),
    ("_zeros", {"shape": (2,), "dtype": "int32"}),
    ("_ones", {"shape": (3, 1)}), ("_ones", {"shape": (2,),
                                             "dtype": "float16"}),
    ("_full", {"shape": (2, 2), "value": 3.5}),
    ("_full", {"shape": (3,), "value": 7, "dtype": "int32"}),
    ("_arange", {"start": 5}), ("_arange", {"start": 1.0, "stop": 4.0,
                                            "step": 0.5}),
    ("_arange", {"start": 0, "stop": 6, "step": 2, "repeat": 3}),
    ("_arange", {"start": 2, "stop": 9, "dtype": "int32"}),
    ("_linspace", {"start": 0.0, "stop": 1.0, "num": 5}),
    ("_linspace", {"start": -1.0, "stop": 2.0, "num": 7,
                   "endpoint": False}),
]


@pytest.mark.parametrize("case", CREATION, ids=lambda c: c[0])
def test_creation_ops(case):
    name, kw = case
    check(name, [], kw)


# ------------------------------------------------------------- the rest ---

REST = [
    ("multi_sum_sq", [_rand(3), _rand(2, 2, seed=1), _rand(5, seed=2)],
     {"num_arrays": 3}, (0, 1, 2)),
    ("add_n", [_rand(2, 3), _rand(2, 3, seed=1), _rand(2, 3, seed=2)], {},
     (0, 1, 2)),
    ("ElementWiseSum", [_rand(2, 3), _rand(2, 3, seed=1)], {}, (0, 1)),
    ("_sum", [_rand(2, 3), _rand(2, 3, seed=1)], {}, (0,)),
    ("moments", [_rand(3, 4, 5)], {"axes": (0, 2)}, (0,)),
    ("moments", [_rand(3, 4)], {"axes": (1,), "keepdims": True}, (0,)),
    ("moments", [_rand(3, 4)], {}, (0,)),
    ("softmax_cross_entropy", [_rand(4, 5), np.array([0, 4, 2, 2],
                                                     np.float32)], {}, (0,)),
    ("digamma", [_rand(3, 4, lo=0.3, hi=4.0)], {}, (0,)),
    ("_histogram", [_rand(50)], {"bin_cnt": 7}, ()),
    ("histogram", [_rand(50)], {"bin_cnt": 4, "range": (-1.0, 1.0)}, ()),
    ("col2im", [_rand(2, 3 * 2 * 2, 9)], {"output_size": (4, 4),
                                          "kernel": (2, 2)}, (0,)),
    ("col2im", [_rand(1, 2 * 3 * 3, 9)], {"output_size": (5, 5),
                                          "kernel": (3, 3), "stride": (2, 2),
                                          "pad": (1, 1)}, (0,)),
    ("col2im", [_rand(1, 2 * 2 * 2, 16)], {"output_size": (6, 6),
                                           "kernel": (2, 2),
                                           "dilate": (2, 2)}, (0,)),
    ("_slice_assign", [_rand(4, 5), _rand(2, 3, seed=1)],
     {"begin": (1, 0), "end": (3, 5), "step": (1, 2)}, (0, 1)),
    ("_slice_assign", [_rand(4, 5), _rand(2, 5, seed=1)],
     {"begin": (1,), "end": (3,)}, (0, 1)),
    ("_slice_assign_scalar", [_rand(4, 5)], {"scalar": 2.5, "begin": (0, 1),
                                             "end": (2, 4)}, (0,)),
    ("_rnn_param_concat", [_rand(2, 3), _rand(4, seed=1)], {}, (0, 1)),
    ("_rnn_param_concat", [_rand(2, 3), _rand(2, 2, seed=1)], {"dim": 1},
     (0, 1)),
    ("_identity_with_attr_like_rhs", [_rand(2, 3), _rand(2, 3, seed=1)],
     {}, (0,)),
]


@pytest.mark.parametrize("case", REST, ids=lambda c: c[0])
def test_rest(case):
    name, arrays, kw, argnums = case
    check(name, arrays, kw, argnums=argnums)


def test_histogram_with_explicit_edges():
    x = _rand(40)
    edges = np.array([-2.0, -0.5, 0.0, 0.3, 2.0], np.float32)
    with CPU:
        counts, got = mx.nd.invoke("_histogram", mx.nd.array(x),
                                   bins=mx.nd.array(edges)._data)
    want, _ = np.histogram(x, bins=edges)
    np.testing.assert_array_equal(counts.asnumpy(), want)
    np.testing.assert_array_equal(got.asnumpy(), edges)
