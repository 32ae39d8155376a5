"""Per-op parameter schemas: the dmlc::Parameter layer.

Counterpart of ``mxnet_tpu/ops/schema.py``, with its messages word for
word. An op's hyper-parameters are the keyword arguments of its
function, so the schema is derived from the signature (name, default,
and a type taken from the default) and enriched per op through
``register(..., param_specs=...)`` (range, choices, doc). It gives:

* validation: an unknown keyword raises ``OpParamError`` naming the op,
  a "did you mean" and the valid parameters, when the op is called
  (``ndarray._invoke``) or a node is built (``symbol``), never inside a
  captured replay;
* dmlc-style string coercion: ``"2"`` -> 2, ``"(1, 2)"`` -> (1, 2),
  ``"True"`` -> True, as symbol JSON carries attributes;
* range and choices checks for the enriched specs;
* ``describe()`` dumps, read by ``registry.op_schemas()``.

It reads no tensor and makes no host sync.
"""
from __future__ import annotations

import ast
import inspect
from typing import Any, Dict, Optional

from ..base import MXNetError

__all__ = ["OpParamError", "ParamSpec", "OpSchema",
           "OPTIONAL_ARRAY_PARAMS", "RUNTIME_PARAMS"]

_REQUIRED = object()

# Signature params that are ARRAY INPUTS even though they default to None
# (optional weights/labels/keys) — used by OpSchema.from_fn to keep them
# out of the hyper-parameter dump. The symbol layer classifies inputs
# from Symbol-ness at compose time and consumes RUNTIME_PARAMS below;
# keep this set in sync with its expectations when adding ops.
OPTIONAL_ARRAY_PARAMS = frozenset(
    {"bias", "gamma", "beta", "moving_mean", "moving_var", "weight",
     "state", "state_cell", "label", "data_lengths", "label_lengths",
     "sequence_length", "lhs", "rhs", "mean", "var", "grad", "mom",
     "condition", "index", "indices", "a", "b", "x", "y", "data", "key"})

# Runtime-injected params — never graph inputs, never static attrs.
RUNTIME_PARAMS = frozenset({"key", "training"})

# The port's own runtime arguments: the torch.Generator a sampler draws
# from and the device a creation op makes its output on. The frontends
# pass them; a schema accepts them and lists them nowhere, so an op's
# parameters and messages are the JAX package's.
PORT_RUNTIME_PARAMS = frozenset({"generator", "device"})


class OpParamError(MXNetError):
    """Invalid hyper-parameter for a registered op (structured analogue
    of dmlc::ParamError)."""

    def __init__(self, op_name, param, reason, valid=None):
        self.op_name = op_name
        self.param = param
        self.reason = reason
        msg = f"op {op_name!r}, parameter {param!r}: {reason}"
        if valid:
            msg += f"; valid parameters: {sorted(valid)}"
        super().__init__(msg)


class ParamSpec:
    """One hyper-parameter: name, inferred/declared type, default, and
    optional doc/range/choices enrichment."""

    __slots__ = ("name", "type", "default", "doc", "choices", "low", "high")

    def __init__(self, name, type=None, default=_REQUIRED, doc="",
                 choices=None, low=None, high=None):
        self.name = name
        self.type = type
        self.default = default
        self.doc = doc
        self.choices = tuple(choices) if choices is not None else None
        self.low = low
        self.high = high

    @property
    def required(self):
        return self.default is _REQUIRED

    def describe(self) -> Dict[str, Any]:
        out = {"name": self.name,
               "type": self.type.__name__ if self.type else "any"}
        if not self.required:
            out["default"] = self.default
        else:
            out["required"] = True
        if self.doc:
            out["doc"] = self.doc
        if self.choices is not None:
            out["choices"] = list(self.choices)
        if self.low is not None:
            out["low"] = self.low
        if self.high is not None:
            out["high"] = self.high
        return out

    # ------------------------------------------------------- validation ---
    def coerce(self, op_name, value):
        """dmlc-style scalar parsing + type/range/choices checks."""
        t = self.type
        was_string = isinstance(value, str) and t not in (None, str)
        if was_string:
            try:
                value = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                raise OpParamError(
                    op_name, self.name,
                    f"cannot parse {value!r} as {t.__name__}") from None
        if t is bool and isinstance(value, int) and not isinstance(value, bool):
            value = bool(value)
        elif t is float and isinstance(value, int) and not isinstance(value, bool):
            value = float(value)
        elif t is int and isinstance(value, float) and value.is_integer():
            value = int(value)
        elif t in (tuple, list) and isinstance(value, (tuple, list)):
            value = t(value)
        # Type enforcement, dmlc-style but Python-polymorphism-aware:
        # a string that parsed to the wrong type, or a bare scalar where
        # a shape tuple is declared, raises HERE with op/param context
        # instead of a TypeError deep inside the jit trace. Other
        # mismatches pass — many params are deliberately polymorphic
        # (dtype accepts str or np.dtype; tensordot axes int or tuple).
        if t not in (None, object) and value is not None:
            wrong = not isinstance(value, t) and \
                not (t is float and isinstance(value, int))
            scalar_for_shape = t in (tuple, list) and \
                isinstance(value, (int, float, bool))
            if (was_string and wrong) or scalar_for_shape:
                raise OpParamError(
                    op_name, self.name,
                    f"expected {t.__name__}, got {type(value).__name__} "
                    f"({value!r})")
        if self.choices is not None and value not in self.choices:
            raise OpParamError(
                op_name, self.name,
                f"got {value!r}, expected one of {list(self.choices)}")
        if self.low is not None and isinstance(value, (int, float)) \
                and value < self.low:
            raise OpParamError(
                op_name, self.name, f"{value!r} is below minimum {self.low}")
        if self.high is not None and isinstance(value, (int, float)) \
                and value > self.high:
            raise OpParamError(
                op_name, self.name, f"{value!r} is above maximum {self.high}")
        return value


class OpSchema:
    """Array inputs + hyper-parameter specs of one op, derived from its
    function signature."""

    __slots__ = ("op_name", "inputs", "variadic", "params", "open_kwargs")

    def __init__(self, op_name, inputs, variadic, params, open_kwargs):
        self.op_name = op_name
        self.inputs = inputs          # positional array-input names
        self.variadic = variadic      # fn takes *arrays
        self.params = params          # {name: ParamSpec}
        self.open_kwargs = open_kwargs  # fn has **kw: accept any name

    @classmethod
    def from_fn(cls, op_name, fn, overrides: Optional[dict] = None):
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            return cls(op_name, [], True, {}, True)
        inputs, params = [], {}
        variadic = open_kwargs = False
        for p in sig.parameters.values():
            if p.name in PORT_RUNTIME_PARAMS:
                continue
            if p.kind is inspect.Parameter.VAR_POSITIONAL:
                variadic = True
            elif p.kind is inspect.Parameter.VAR_KEYWORD:
                open_kwargs = True
            elif p.default is inspect.Parameter.empty:
                if p.kind is inspect.Parameter.KEYWORD_ONLY:
                    params[p.name] = ParamSpec(p.name)
                else:
                    inputs.append(p.name)
            elif p.default is None and p.name in OPTIONAL_ARRAY_PARAMS:
                # optional array input (bias/gamma/key/...), not a hyper
                inputs.append(p.name)
            else:
                d = p.default
                t = None if d is None else type(d)
                params[p.name] = ParamSpec(p.name, type=t, default=d)
        for name, extra in (overrides or {}).items():
            if name not in params and not open_kwargs:
                # a typo'd enrichment key would otherwise silently mint a
                # new accepted parameter AND leave the real one unchecked
                raise ValueError(
                    f"op {op_name!r}: param_specs entry {name!r} does not "
                    f"match any signature parameter {sorted(params)}")
            base = params.get(name) or ParamSpec(name)
            if isinstance(extra, ParamSpec):
                params[name] = extra
            else:
                for k, v in dict(extra).items():
                    setattr(base, k, v)
                params[name] = base
        return cls(op_name, inputs, variadic, params, open_kwargs)

    def validate(self, kwargs: dict) -> dict:
        """Check names, parse strings, apply range/choices. Returns the
        coerced kwargs (input dict is not mutated)."""
        if not kwargs:
            return kwargs
        out = {}
        for k, v in kwargs.items():
            spec = self.params.get(k)
            if spec is None:
                if self.open_kwargs or k in self.inputs or \
                        k in PORT_RUNTIME_PARAMS:
                    out[k] = v
                    continue
                from ..base import did_you_mean

                reason = "unknown parameter" + did_you_mean(
                    k, list(self.params) + list(self.inputs))
                raise OpParamError(
                    self.op_name, k, reason, valid=self.params.keys())
            out[k] = spec.coerce(self.op_name, v)
        return out

    def describe(self) -> Dict[str, Any]:
        return {
            "op": self.op_name,
            "inputs": list(self.inputs) + (["*arrays"] if self.variadic
                                           else []),
            "params": [s.describe() for s in self.params.values()],
        }
