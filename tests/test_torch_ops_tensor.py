"""The port's tensor structure ops (ops/tensor.py) against the JAX
package's on the same numpy inputs, one parametrised test per family
(reductions, ordering, products, indexing here; the shape, sequence,
creation and other ops in ``tests/test_torch_ops_tensor_shape.py``):
the forward, and for differentiable ops the gradient under
``autograd.record()`` / ``backward()`` with a fixed head gradient
against ``jax.vjp`` (float32 rtol=1e-5, atol=1e-6; integer-valued
outputs and indices exactly). Also: every name that
``mxnet_tpu/ops/tensor.py`` and ``mxnet_tpu/ops/math.py`` register is in
the port's registry (but for the ten that wait for ``la_op.py`` and
row-sparse arrays), with the same keyword arguments and defaults."""
import inspect
import os

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as preg
from test_torch_ops_math import CPU, _rand, check

# ties are kept where the JAX package decides them (first index for
# argmax and topk, the stable order for sort/argsort, an even split of
# max/min's gradient)
TIES = np.array([[1.0, 3.0, 3.0, -1.0, 0.5],
                 [2.0, 2.0, 0.0, 2.0, -4.0],
                 [0.0, -1.0, 5.0, 5.0, 5.0]], np.float32)


# ----------------------------------------------------------- reductions ---

REDUCE_AXES = [{}, {"axis": 1}, {"axis": (0, 2)}, {"axis": -1,
                                                   "keepdims": True},
               {"axis": 1, "exclude": True}, {"keepdims": True}]


@pytest.mark.parametrize("kw", REDUCE_AXES, ids=str)
@pytest.mark.parametrize("name", ["sum", "mean", "prod", "nansum",
                                  "nanprod", "max", "min", "_np_sum",
                                  "_np_max"])
def test_reductions(name, kw):
    x = _rand(3, 4, 5, lo=0.5, hi=1.5) if "prod" in name else _rand(3, 4, 5)
    if name in ("nansum", "nanprod"):
        x[0, 1, 2] = np.nan
    if name.endswith(("max", "min")):
        x[1, :2, :] = 0.25     # ties share the gradient
    check(name, [x], kw, argnums=(0,))


@pytest.mark.parametrize("kw", [{}, {"ord": 1}, {"axis": 1},
                                {"ord": 1, "axis": (0, 1),
                                 "keepdims": True}], ids=str)
def test_norm(kw):
    check("norm", [_rand(3, 4, 2)], kw, argnums=(0,))


def test_reductions_of_integers_keep_their_dtype():
    x = np.arange(24, dtype=np.int32).reshape(2, 3, 4)
    for name in ("sum", "max", "min", "prod", "mean"):
        check(name, [x % 5 + 1], {"axis": 1})


# ------------------------------------------------------------- ordering ---

ORDERING = [
    ("argmax", {}), ("argmax", {"axis": 1}), ("argmax", {"axis": 0,
                                                         "keepdims": True}),
    ("argmax", {"keepdims": True}),
    ("argmin", {"axis": 1}), ("argmin", {}),
    ("argsort", {}), ("argsort", {"axis": 0}), ("argsort",
                                                {"is_ascend": False}),
    ("sort", {}), ("sort", {"axis": 0, "is_ascend": False}),
    ("topk", {"k": 2}), ("topk", {"k": 3, "ret_typ": "value"}),
    ("topk", {"k": 2, "ret_typ": "both", "axis": 0}),
    ("topk", {"k": 2, "is_ascend": True, "ret_typ": "both"}),
    ("topk", {"k": 2, "dtype": "int32"}),
    ("argmax_channel", {}),
]


@pytest.mark.parametrize("case", ORDERING, ids=str)
def test_ordering(case):
    name, kw = case
    check(name, [TIES], kw, argnums=(0,) if name == "sort" else ())
    check(name, [_rand(4, 6, 3) if name != "argmax_channel" else
                 _rand(4, 6)], kw, argnums=(0,) if name == "sort" else ())


def test_ordering_outputs_carry_no_gradient():
    with CPU:
        x = mx.nd.array(TIES)
        x.attach_grad()
        with mx.autograd.record():
            idx = mx.nd.argmax(x, axis=1)
            vals = mx.nd.topk(x, k=2, ret_typ="value")
        assert not idx._data.requires_grad
        assert not vals._data.requires_grad
        assert idx.dtype == mx.nd.array([1.0]).dtype


def test_topk_mask_marks_the_top_k_as_mxnet():
    """``ret_typ="mask"``: 1/0 at the top-k positions in the input's
    dtype (MXNet's meaning; the JAX body has no mask branch and returns
    the indices)."""
    with CPU:
        got = mx.nd.topk(mx.nd.array(TIES), k=2, ret_typ="mask").asnumpy()
    idx = np.asarray(jreg.get("topk").fn(TIES, k=2)).astype(int)
    want = np.zeros_like(TIES)
    np.put_along_axis(want, idx, 1.0, axis=-1)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- products ---

PRODUCTS = [
    ("dot", [_rand(5), _rand(5, seed=1)], {}),
    ("dot", [_rand(3, 4), _rand(4, 5, seed=1)], {}),
    ("dot", [_rand(2, 3, 4), _rand(4, 5, seed=1)], {}),
    ("dot", [_rand(4, 3), _rand(4, 5, seed=1)], {"transpose_a": True}),
    ("dot", [_rand(3, 4), _rand(5, 4, seed=1)], {"transpose_b": True}),
    ("dot", [_rand(4, 3), _rand(5, 4, seed=1)], {"transpose_a": True,
                                                  "transpose_b": True}),
    ("batch_dot", [_rand(2, 3, 4), _rand(2, 4, 5, seed=1)], {}),
    ("batch_dot", [_rand(2, 4, 3), _rand(2, 5, 4, seed=1)],
     {"transpose_a": True, "transpose_b": True}),
]


@pytest.mark.parametrize("case", PRODUCTS, ids=lambda c: c[0])
def test_products(case):
    name, arrays, kw = case
    check(name, arrays, kw, argnums=(0, 1))


# ------------------------------------------------------------- indexing ---

IDX = np.array([[0, 2.0], [3.7, -1.0]], np.float32)   # floats truncate
INDEXING = [
    ("take", [_rand(4, 3), IDX], {}, (0,)),
    ("take", [_rand(4, 3), IDX], {"mode": "wrap"}, (0,)),
    ("take", [_rand(2, 5, 3), IDX], {"axis": 1, "mode": "clip"}, (0,)),
    ("pick", [_rand(3, 4), np.array([0, 3, 1], np.float32)], {}, (0,)),
    ("gather_nd", [_rand(3, 4), np.array([[0, 2, 1], [3, 0, 3]],
                                         np.float32)], {}, (0,)),
    ("scatter_nd", [_rand(4), np.array([[0, 1, 0, 2], [1, 2, 1, 0]],
                                       np.float32)], {"shape": (3, 3)},
     (0,)),
    ("_scatter_set_nd", [_rand(3, 3), _rand(2, seed=1),
                         np.array([[0, 2], [1, 0]], np.float32)], {},
     (0, 1)),
    ("one_hot", [np.array([0, 2, 5, 1], np.float32)], {"depth": 4}, ()),
    ("one_hot", [np.array([[0, 2], [3, 1]], np.float32)],
     {"depth": 4, "on_value": 2.0, "off_value": -1.0, "dtype": "int32"},
     ()),
    ("where", [np.array([[1, 0, 1], [0, 0, 1]], np.float32), _rand(2, 3),
               _rand(2, 3, seed=1)], {}, (1, 2)),
    ("batch_take", [_rand(3, 4), np.array([1, 0, 3], np.float32)], {},
     (0,)),
    ("choose_element_0index", [_rand(3, 4), np.array([2, 0, 1],
                                                     np.float32)], {}, (0,)),
    ("fill_element_0index", [_rand(3, 4), _rand(3, seed=1),
                             np.array([2, 0, 1], np.float32)], {}, (0, 1)),
    ("Embedding", [np.array([[0, 3.0], [2, 2]], np.float32), _rand(4, 3)],
     {"input_dim": 4, "output_dim": 3}, (1,)),
]


@pytest.mark.parametrize("case", INDEXING, ids=lambda c: c[0])
def test_indexing(case):
    name, arrays, kw, argnums = case
    check(name, arrays, kw, argnums=argnums)


def test_boolean_mask_is_eager_and_detached():
    x, m = _rand(4, 3), np.array([1, 0, 1, 1], np.float32)
    check("boolean_mask", [x, m])
    check("boolean_mask", [x, np.array([0, 1, 1], np.float32)], {"axis": 1})


# ------------------------------------------------------------ registry ----

_REF = os.path.join(os.path.dirname(__file__), "..", "mxnet_tpu", "ops")
# none left out: _sparse_retain and cast_storage came with the row-sparse
# arrays, the linalg ops and khatri_rao with ops/la_op.py;
# _contrib_SparseEmbedding is registered by ops/nn.py
LEFT_OUT = set()
# registered by numpy_ops.py as aliases of tensor.py's ops
NUMPY_ALIASES = {"_split_v2", "_unravel_index", "_ravel_multi_index"}


def _registered_by(module):
    """Every name (aliases included) that ``mxnet_tpu/ops/<module>.py``
    registers: its source run with a ``register`` that records."""
    names = []

    def register(name, aliases=(), **kw):
        names.append(name)
        names.extend(aliases)
        return lambda fn: fn

    path = os.path.join(_REF, module + ".py")
    src = open(path).read().replace("from .registry import register", "")
    exec(compile(src, path, "exec"), {"__name__": "scan",
                                      "register": register})
    return names


@pytest.mark.parametrize("module", ["math", "tensor"])
def test_every_name_of_the_reference_module_is_registered(module):
    names = set(_registered_by(module))
    if module == "tensor":
        assert "linalg_gemm2" in names and "cast_storage" in names
        names |= NUMPY_ALIASES | {"_contrib_SparseEmbedding",
                                  "_linalg_gemm2", "_linalg_potrf",
                                  "_linalg_syrk"}
    missing = sorted(n for n in names - LEFT_OUT
                     if n not in preg._REGISTRY)
    assert not missing, missing
    assert len(names - LEFT_OUT) > (70 if module == "tensor" else 100)
    for name in LEFT_OUT:
        with pytest.raises(mx.MXNetError, match="not ported"):
            preg.get(name)


@pytest.mark.parametrize("module", ["math", "tensor"])
def test_keyword_arguments_and_defaults_match_the_reference(module):
    """Each op's hyper-parameters: the same names and defaults as the JAX
    function's (``ctx`` of the creation ops included)."""
    for name in set(_registered_by(module)) - LEFT_OUT:
        jfn = jreg.get(name).fn
        if not getattr(jfn, "__module__", "").startswith("mxnet_tpu"):
            continue   # a jnp/lax function: one array, no op keywords
        jsig = inspect.signature(jfn)
        psig = inspect.signature(preg.get(name))
        want = {p.name: p.default for p in jsig.parameters.values()
                if p.default is not inspect.Parameter.empty}
        got = {p.name: p.default for p in psig.parameters.values()
               if p.default is not inspect.Parameter.empty}
        if name == "LeakyReLU":
            continue   # ops/nn.py's, with its own contract
        assert got == want, (name, got, want)


def test_differentiable_flags_follow_the_reference():
    for name in set(_registered_by("tensor")) - LEFT_OUT:
        assert preg.differentiable(name) == jreg.get(name).differentiable, \
            name
