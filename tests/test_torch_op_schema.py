"""The port's op schemas (``ops/schema.py``) against the JAX package's,
case for case from tests/test_op_schema.py: each ``OpParamError`` is
raised by both packages and its message is compared as a string, word
for word; string coercion, range and choices checks and the JSON round
trip agree. Also: a misspelt keyword raises at the call
(``mx.nd.softmax(a, axs=0)``) and at symbol construction
(``mx.sym.FullyConnected(d, num_hiden=3)``), and ``op_schemas()``
describes every registered op as the JAX package does where their
signatures agree.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.ops.schema import OpParamError as JOpParamError
from mxnet_tpu.ops.schema import ParamSpec as JParamSpec
from mxnet_tpu_torch.ops import registry
from mxnet_tpu_torch.ops.schema import OpParamError, OpSchema, ParamSpec


def _both_raise(op, kwargs):
    """The two packages' OpParamError for ``op``'s ``kwargs``; the
    messages must be equal."""
    with pytest.raises(OpParamError) as pe:
        registry.op(op).check_kwargs(kwargs)
    with pytest.raises(JOpParamError) as je:
        jreg.get(op).check_kwargs(kwargs)
    assert str(pe.value) == str(je.value)
    assert (pe.value.op_name, pe.value.param) == \
        (je.value.op_name, je.value.param)
    return str(pe.value), pe.value


def test_activation_bad_choice_message():
    msg, err = _both_raise("Activation", {"act_type": "rleu"})
    assert "'Activation'" in msg and "'act_type'" in msg
    assert "'rleu'" in msg and "relu" in msg and "sigmoid" in msg
    assert err.op_name == "Activation" and err.param == "act_type"


def test_pooling_bad_choice_message():
    msg, _ = _both_raise("Pooling", {"pool_type": "average"})
    assert "'Pooling'" in msg and "'pool_type'" in msg
    assert "max" in msg and "avg" in msg


@pytest.mark.parametrize("p,word", [(1.5, "maximum"), (-0.1, "minimum")])
def test_dropout_range_message(p, word):
    msg, _ = _both_raise("Dropout", {"p": p})
    assert "'Dropout'" in msg and "'p'" in msg and word in msg


def test_fully_connected_unknown_param_suggests():
    msg, _ = _both_raise("FullyConnected", {"num_hiden": 16})
    assert "'FullyConnected'" in msg and "'num_hiden'" in msg
    assert "did you mean 'num_hidden'" in msg
    assert "valid parameters" in msg and "no_bias" in msg


def test_convolution_scalar_for_shape_message():
    msg, _ = _both_raise("Convolution", {"kernel": 3, "num_filter": 8})
    assert "'Convolution'" in msg and "'kernel'" in msg
    assert "expected tuple" in msg and "int" in msg


def test_concat_string_parse_failure_message():
    msg, _ = _both_raise("Concat", {"dim": "one"})
    assert "'Concat'" in msg and "'dim'" in msg and "cannot parse" in msg


def test_registry_unknown_op_suggests():
    with pytest.raises(KeyError) as pe:
        registry.get("Activaton")
    with pytest.raises(KeyError) as je:
        jreg.get("Activaton")
    assert "Activation" in str(pe.value) and "Activation" in str(je.value)
    # the same hint, "ops available" counts aside
    assert str(pe.value).split("available)")[1] == \
        str(je.value).split("available)")[1].rstrip("'\"")


def test_coerce_dmlc_string_forms():
    kw = {"kernel": "(2, 2)", "stride": "(2, 2)", "global_pool": "True",
          "pool_type": "avg"}
    out = registry.op("Pooling").check_kwargs(kw)
    assert out == jreg.get("Pooling").check_kwargs(kw)
    assert out["kernel"] == (2, 2) and isinstance(out["kernel"], tuple)
    assert out["global_pool"] is True
    out = registry.op("Dropout").check_kwargs({"p": "0.25"})
    assert out == jreg.get("Dropout").check_kwargs({"p": "0.25"})
    assert out["p"] == pytest.approx(0.25)


def test_coerce_int_float_promotions():
    for spec_cls in (ParamSpec, JParamSpec):
        assert spec_cls("x", type=float, default=0.0).coerce("op", 2) == 2.0
        assert spec_cls("n", type=int, default=1).coerce("op", 3.0) == 3
        assert spec_cls("flag", type=bool,
                        default=False).coerce("op", 1) is True


def test_coerce_choices_and_range_direct():
    msgs = []
    for spec_cls, err in ((ParamSpec, OpParamError),
                          (JParamSpec, JOpParamError)):
        spec = spec_cls("mode", type=str, default="a", choices=("a", "b"))
        with pytest.raises(err) as ei:
            spec.coerce("myop", "c")
        assert "'myop'" in str(ei.value) and "['a', 'b']" in str(ei.value)
        msgs.append(str(ei.value))
        spec = spec_cls("k", type=int, default=1, low=1, high=5)
        for bad in (0, 9):
            with pytest.raises(err) as ei:
                spec.coerce("myop", bad)
            msgs.append(str(ei.value))
        assert spec.coerce("myop", "3") == 3
    assert msgs[:3] == msgs[3:]


def test_schema_from_fn_override_typo_rejected():
    def fake_op(data, alpha=1.0):
        return data

    with pytest.raises(ValueError) as ei:
        OpSchema.from_fn("fake", fake_op, {"alhpa": {"low": 0.0}})
    assert "alhpa" in str(ei.value)


def test_validate_does_not_mutate_input():
    kwargs = {"p": "0.5"}
    out = registry.schema("Dropout").validate(kwargs)
    assert kwargs == {"p": "0.5"} and out["p"] == 0.5


def test_tojson_load_roundtrip_and_load_time_error():
    """save -> load keeps arguments and shapes, and a corrupted
    attribute raises OpParamError at load in both packages with one
    message. (The JAX ``Symbol.verify`` graph checker waits for
    ``analysis/``, ROADMAP A11.)"""
    def build(pkg):
        data = pkg.sym.var("data")
        conv = pkg.sym.Convolution(data, kernel=(3, 3), num_filter=8,
                                   pad=(1, 1), name="conv")
        bn = pkg.sym.BatchNorm(conv, name="bn")
        act = pkg.sym.Activation(bn[0] if len(bn) > 1 else bn,
                                 act_type="relu", name="act")
        return pkg.sym.Pooling(act, kernel=(2, 2), stride=(2, 2),
                               pool_type="max", name="pool")

    pool, jpool = build(mx), build(jmx)
    js = pool.tojson()
    loaded = mx.sym.load_json(js)
    assert loaded.list_arguments() == pool.list_arguments()
    s1 = pool.infer_shape(data=(2, 3, 8, 8))[1]
    s2 = loaded.infer_shape(data=(2, 3, 8, 8))[1]
    assert s1 == s2
    assert s1 == jpool.infer_shape(data=(2, 3, 8, 8))[1]
    jjs = jpool.tojson()
    assert '"pool_type": "max"' in js and '"pool_type": "max"' in jjs
    bad = js.replace('"pool_type": "max"', '"pool_type": "mox"')
    jbad = jjs.replace('"pool_type": "max"', '"pool_type": "mox"')
    with pytest.raises(OpParamError) as pe:
        mx.sym.load_json(bad)
    with pytest.raises(JOpParamError) as je:
        jmx.sym.load_json(jbad)
    assert str(pe.value) == str(je.value)
    assert "'Pooling'" in str(pe.value) and "'mox'" in str(pe.value)
    # the port reads the JAX package's JSON, and the JAX package the port's
    assert mx.sym.load_json(jjs).list_arguments() == \
        jmx.sym.load_json(js).list_arguments()
    assert json.loads(js)["nodes"][-1]["op"] == "Pooling"


def test_misspelt_keywords_raise_at_the_call_and_at_construction():
    a = mx.nd.array(np.ones((2, 3), np.float32), ctx=mx.cpu())
    with pytest.raises(OpParamError) as pe:
        mx.nd.softmax(a, axs=0)
    with pytest.raises(JOpParamError) as je:
        jmx.nd.softmax(jmx.nd.ones((2, 3)), axs=0)
    assert str(pe.value) == str(je.value)
    assert "(did you mean 'axis'?)" in str(pe.value)
    with pytest.raises(OpParamError) as pe:
        mx.sym.FullyConnected(mx.sym.var("d"), num_hiden=3)
    with pytest.raises(JOpParamError) as je:
        jmx.sym.FullyConnected(jmx.sym.var("d"), num_hiden=3)
    assert str(pe.value) == str(je.value)


def test_op_schemas_cover_every_op_and_agree_where_signatures_do():
    """One schema per registered op in both packages, with the same
    parameters but where the JAX op's function shows what the port's
    does not: the legacy ops that are bare jnp ufuncs or jax functions
    (their ``out``/``where``/``out_sharding``/``accuracy`` keywords), the
    ``_npi_*_scalar`` closures' ``_fn``/``_rev`` defaults, the open
    keywords of the JAX ``_contrib_BatchNormWithReLU``/``SyncBatchNorm``,
    and the port's ``training`` of ``RNN`` and ``Custom``. Every one of
    the 271 NumPy-frontend names but the scalar ops agrees."""
    ours, theirs = registry.op_schemas(), jreg.op_schemas()
    assert sorted(ours) == sorted(theirs)
    differ = sorted(
        n for n in ours
        if sorted(p["name"] for p in ours[n]["params"])
        != sorted(p["name"] for p in theirs[n]["params"]))
    scalar = [f"_npi_{n}_scalar" for n in (
        "add", "subtract", "rsubtract", "multiply", "true_divide",
        "rtrue_divide", "mod", "rmod", "power", "rpower", "floor_divide",
        "rfloor_divide")]
    assert differ == sorted([
        "_contrib_BatchNormWithReLU", "_contrib_SyncBatchNorm", "Custom",
        "RNN", "broadcast_add", "broadcast_logical_and",
        "broadcast_logical_or", "broadcast_logical_xor",
        "broadcast_maximum", "broadcast_minimum", "broadcast_mul",
        "broadcast_sub", "negative", "ones_like", "round", "rsqrt",
        "zeros_like"] + scalar), differ
    for n in scalar:
        assert {p["name"] for p in theirs[n]["params"]} - \
            {p["name"] for p in ours[n]["params"]} == {"_fn", "_rev"}
