"""Symbol: the op graph that ``HybridBlock.export`` traces, the
quantization pass rewrites, the symbol loaders serve and ``bind`` /
``simple_bind`` turn into an :class:`~mxnet_tpu_torch.executor.Executor`.

Counterpart of the core of ``mxnet_tpu/symbol/symbol.py``: ``_Node``
:94, ``_topo`` :115, ``Symbol`` :133 (lists of arguments, auxiliary
states and outputs, ``get_internals`` :189, ``infer_shape`` :258,
``infer_shape_partial`` :282, ``infer_type`` :288-333, ``_build_eval``
:409 with the BatchNorm statistics' writeback ``_bn_aux_update`` :692,
``eval_with`` :506, ``eval`` :528, ``simple_bind`` :533, ``bind`` :574,
``tojson`` :597, ``save``), ``_apply_op`` :858, ``var`` :949, ``Group``
:970, ``load_json`` :993 and ``load`` :1043, over the port's op
registry. Graph JSON is the JAX package's format both ways (attributes
as Python literals, ``_attr_str`` / ``_parse_attr``, then brought to the
types of the op's defaults as the JAX schema does, ``_coerce_attrs``), so
a graph written by either package loads in the other, calibration floats
exactly. Composition takes variadic ops (``Concat``, ``stack``,
``add_n``: every positional Symbol), output counts that follow the
hyper-parameters (``SliceChannel``, ``split_v2``) and the JAX package's
Symbol arithmetic (``+ - * /`` with a Symbol or a number, ``**``,
negation).

Evaluation walks the nodes in topological order and calls each op's
PyTorch function on the tensors (there is no ``jit``: PyTorch runs
eagerly), so on a card every kernel family launches as it does in the
imperative path. Shape and type inference run the same walk on ``meta``
tensors, which carry shapes and dtypes and no data. Types are
``torch.dtype``s, as the port's ``NDArray.dtype`` is.
"""
from __future__ import annotations

import ast
import inspect
import json

import torch

from .. import _amp_core
from .. import attribute as _attribute
from ..attribute import is_dunder as _is_dunder
from ..base import MXNetError, canonical_dtype, dtype_name
from ..ops import registry as _registry
from ..ops.nn import rnn_param_size

__all__ = ["Symbol", "var", "Group", "load", "load_json", "register_pass",
           "list_passes", "GRAPH_PASSES"]

# the ops whose training forward writes running statistics into their
# auxiliary inputs 3 and 4
_BATCH_NORMS = ("BatchNorm", "BatchNorm_v1", "_contrib_SyncBatchNorm")
# auto-created parameter inputs of layer ops:
# arg name -> (suffix, skip_if, is_aux)
_LAYER_PARAMS = {
    "FullyConnected": {"weight": ("weight", None, False),
                       "bias": ("bias", lambda a: a.get("no_bias", False),
                                False)},
    "Convolution": {"weight": ("weight", None, False),
                    "bias": ("bias", lambda a: a.get("no_bias", False),
                             False)},
    "Deconvolution": {"weight": ("weight", None, False),
                      "bias": ("bias", lambda a: a.get("no_bias", True),
                               False)},
    "GroupNorm": {"gamma": ("gamma", None, False),
                  "beta": ("beta", None, False)},
    "InstanceNorm": {"gamma": ("gamma", None, False),
                     "beta": ("beta", None, False)},
    # PReLU's learned slope
    "LeakyReLU": {"gamma": ("gamma",
                            lambda a: a.get("act_type", "leaky") != "prelu",
                            False)},
    **{bn: {"gamma": ("gamma", None, False),
            "beta": ("beta", None, False),
            "moving_mean": ("moving_mean", None, True),
            "moving_var": ("moving_var", None, True)}
       for bn in _BATCH_NORMS},
    "LayerNorm": {"gamma": ("gamma", None, False),
                  "beta": ("beta", None, False)},
    "Embedding": {"weight": ("weight", None, False)},
    # the fused RNN's flat vector: "<name>_params", as in the JAX package
    # (MXNet 1.x names it "<name>_parameters")
    "RNN": {"params": ("params", None, False)},
    # loss heads make their label input "<name>_label" when not given
    # (mx.sym.SoftmaxOutput(net, name="softmax") has "softmax_label")
    **{head: {"label": ("label", None, False)} for head in (
        "SoftmaxOutput", "SVMOutput", "LinearRegressionOutput",
        "LogisticRegressionOutput", "MAERegressionOutput")},
}
# arguments the evaluator supplies, never node attributes or inputs
_RUNTIME_PARAMS = frozenset({"training", "generator"})


def _op_kwargs(attrs):
    """Node attributes minus the dunder-keyed ones: variable metadata and
    ``AttrScope`` attributes, which never reach an op."""
    return {k: v for k, v in attrs.items() if not _is_dunder(k)}


def _sig_params(fn):
    return list(inspect.signature(fn).parameters.values())


class _Node:
    """One graph node: an op application, or a variable (``op=None``)."""

    __slots__ = ("op", "name", "attrs", "inputs", "num_outputs")

    def __init__(self, op, name, attrs=None, inputs=(), num_outputs=1):
        self.op = op                  # registered op name, or None
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs)    # [(node, out_index), ...]
        self.num_outputs = num_outputs

    @property
    def is_var(self):
        return self.op is None

    @property
    def is_aux(self):
        return self.is_var and bool(self.attrs.get("__is_aux__", False))


def _topo(entries):
    """Post-order unique node list of the subgraph feeding ``entries``."""
    seen, order = set(), []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for child, _ in node.inputs:
            visit(child)
        order.append(node)

    for node, _ in entries:
        visit(node)
    return order


def _output_name(entry):
    node, idx = entry
    if node.is_var:
        return node.name
    if node.num_outputs == 1:
        return f"{node.name}_output"
    return f"{node.name}_output{idx}"


def _attr_str(v):
    return v if isinstance(v, str) else repr(v)


def _parse_attr(s):
    if not isinstance(s, str):
        return s
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


_BOOL_TEXT = {"true": True, "false": False, "1": True, "0": False}


def _coerce_attrs(op, attrs):
    """Node attributes parsed from JSON strings, brought to the types of
    the op's defaults as the JAX package's schema does
    (``mxnet_tpu/ops/schema.py`` ``ParamSpec.coerce``): an int where a
    float is the default becomes a float, 0/1 or ``"true"``/``"false"``
    where a bool is a bool, a list where a tuple is a tuple, an integral
    float where an int is an int. ``dtype`` names stay strings."""
    defaults = {p.name: p.default for p in _sig_params(_registry.get(op))
                if p.default is not inspect.Parameter.empty}
    out = {}
    for k, v in attrs.items():
        d = defaults.get(k, inspect.Parameter.empty)
        if _is_dunder(k) or d is inspect.Parameter.empty or d is None:
            out[k] = v
        elif isinstance(d, bool):
            out[k] = _BOOL_TEXT.get(v.lower(), v) if isinstance(v, str) \
                else bool(v) if isinstance(v, int) else v
        elif isinstance(d, float) and isinstance(v, int) \
                and not isinstance(v, bool):
            out[k] = float(v)
        elif isinstance(d, int) and isinstance(v, float) and v.is_integer():
            out[k] = int(v)
        elif isinstance(d, tuple) and isinstance(v, list):
            out[k] = tuple(v)
        else:
            out[k] = v
    return out


class Symbol:
    """A list of outputs ``(node, out_index)`` over the graph."""

    def __init__(self, entries):
        self._entries = list(entries)

    @property
    def name(self):
        return self._entries[0][0].name if len(self._entries) == 1 else None

    def __len__(self):
        """The number of outputs (MXNet's ``len(sym)``)."""
        return len(self._entries)

    def __getitem__(self, index):
        if isinstance(index, str):
            for e in self._entries:
                if _output_name(e) == index or e[0].name == index:
                    return Symbol([e])
            raise ValueError(f"no output named {index!r}; outputs: "
                             f"{self.list_outputs()}")
        if isinstance(index, slice):
            return Symbol(self._entries[index])
        return Symbol([self._entries[index]])

    def __repr__(self):
        return f"<Symbol {self.name or 'group'}>"

    # ------------------------------------------------------- operators --
    def _binary(self, other, elemwise_op, scalar_op):
        if isinstance(other, Symbol):
            return _apply_op(elemwise_op, [self, other], {})
        return _apply_op(scalar_op, [self], {"scalar": float(other)})

    def __add__(self, other):
        return self._binary(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "elemwise_sub", "_rminus_scalar")

    def __mul__(self, other):
        return self._binary(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "elemwise_div", "_rdiv_scalar")

    def __neg__(self):
        return _apply_op("_mul_scalar", [self], {"scalar": -1.0})

    def __pow__(self, other):
        if isinstance(other, Symbol):
            return _apply_op("broadcast_power", [self, other], {})
        return _apply_op("_power_scalar", [self], {"scalar": other})

    # ------------------------------------------------------- graph lists --
    def list_arguments(self):
        return [n.name for n in _topo(self._entries)
                if n.is_var and not n.is_aux]

    def list_auxiliary_states(self):
        return [n.name for n in _topo(self._entries) if n.is_aux]

    def list_inputs(self):
        return [n.name for n in _topo(self._entries) if n.is_var]

    def list_outputs(self):
        return [_output_name(e) for e in self._entries]

    def get_internals(self):
        """Every output of every node, as one group."""
        return Symbol([(node, i) for node in _topo(self._entries)
                       for i in range(node.num_outputs)])

    # ----------------------------------------------------------- attrs --
    def attr(self, key):
        """The attribute ``key`` of this one-node symbol as a string, or
        None; a scope attribute is found by its plain key too
        (``"ctx_group"`` for the stored ``"__ctx_group__"``)."""
        if len(self._entries) != 1:
            return None
        attrs = self._entries[0][0].attrs
        value = attrs.get(key)
        if value is None and not _is_dunder(key):
            value = attrs.get(_attribute.dunder(key))
        return None if value is None else str(value)

    def list_attr(self):
        """This one-node symbol's attributes as strings."""
        if len(self._entries) != 1:
            return {}
        return {k: str(v) for k, v in self._entries[0][0].attrs.items()}

    def attr_dict(self):
        """``{node name: {key: string}}`` over the graph's nodes."""
        return {node.name: {k: str(v) for k, v in node.attrs.items()}
                for node in _topo(self._entries) if node.attrs}

    def _set_attr(self, **kwargs):
        for node, _ in self._entries:
            node.attrs.update(kwargs)

    def optimize_for(self, backend, args=None, aux=None, ctx=None,
                     **kwargs):
        """The graph rewritten by the registered pass ``backend``
        (:func:`register_pass`): ``"default"`` (the graph itself),
        ``"amp"`` or ``"int8"``, or one of the caller's. The ``int8`` pass
        returns ``quantize_graph``'s ``(qsym, qspecs)``, as the JAX
        package's does (MXNet 1.x returns a Symbol; ROADMAP C31)."""
        key = (backend or "default").lower()
        try:
            pass_fn = GRAPH_PASSES[key]
        except KeyError:
            raise MXNetError(f"unknown backend {backend!r}; registered: "
                             f"{list_passes()}") from None
        return pass_fn(self, args=args, aux=aux, **kwargs)

    # --------------------------------------------------------- shape/type --
    def infer_shape(self, **shapes):
        """Shapes from the given input shapes: ``(arg_shapes, out_shapes,
        aux_shapes)`` in ``list_arguments()`` / ``list_outputs()`` /
        ``list_auxiliary_states()`` order. Parameter shapes of layer ops
        follow from their data input."""
        shapes, _ = self._checked_infer(shapes, {})
        return self._ordered(shapes)

    def infer_shape_partial(self, **shapes):
        """:meth:`infer_shape`, or ``(None, None, None)`` where the given
        shapes do not determine the graph's."""
        try:
            return self.infer_shape(**shapes)
        except MXNetError:
            return None, None, None

    def infer_type(self, **dtypes):
        """Types from the given input types: ``(arg_types, out_types,
        aux_types)``, as ``torch.dtype``s. With every shape known (from
        the variables' ``__shape__``) the ops run on ``meta`` tensors;
        otherwise each node takes its ``dtype`` attribute or the promoted
        type of its inputs, as the JAX package's fallback does."""
        hints = {k: canonical_dtype(v) for k, v in dtypes.items()}
        try:
            _, types = self._infer_meta({}, hints)
            return self._ordered(types)
        except (MXNetError, KeyError, RuntimeError, TypeError,
                ValueError):
            return self._infer_type_only(hints)

    def _ordered(self, known):
        return ([known["var", n] for n in self.list_arguments()],
                [known[id(n), i] for n, i in self._entries],
                [known["var", n] for n in self.list_auxiliary_states()])

    def _infer_type_only(self, hints):
        types = {}
        for node in _topo(self._entries):
            if node.is_var:
                dt = hints.get(node.name, canonical_dtype(
                    node.attrs.get("__dtype__")))
                types["var", node.name] = types[id(node), 0] = dt
                continue
            if node.attrs.get("dtype") is not None:
                dt = canonical_dtype(node.attrs["dtype"])
            else:
                ins = [types[id(c), oi] for c, oi in node.inputs]
                dt = ins[0] if ins else torch.float32
                for other in ins[1:]:
                    dt = torch.promote_types(dt, other)
            for i in range(node.num_outputs):
                types[id(node), i] = dt
        return self._ordered(types)

    def _checked_infer(self, shape_hints, dtype_hints, fallback=None):
        try:
            return self._infer_meta(shape_hints, dtype_hints, fallback)
        except MXNetError:
            raise
        except Exception as exc:  # noqa: BLE001 - name the failing graph
            raise MXNetError(f"infer_shape failed: {exc}") from exc

    def _infer(self, shape_hints):
        """Shapes keyed by ``("var", name)`` for inputs and ``(id(node),
        out_index)`` for node outputs."""
        return self._infer_meta(shape_hints, {})[0]

    def _infer_meta(self, shape_hints, dtype_hints, fallback=None):
        """Run the graph on ``meta`` tensors. Returns ``(shapes, dtypes)``
        keyed as :meth:`_infer`'s. An input that no hint, ``__shape__``
        or layer rule sizes takes its shape in ``fallback``."""
        fallback = fallback or {}
        meta = torch.device("meta")
        shapes, dtypes, vals = {}, {}, {}

        def put_var(node, shape, dtype):
            dtype = dtype_hints.get(node.name, dtype)
            t = torch.empty(tuple(shape), dtype=canonical_dtype(dtype),
                            device=meta)
            vals[id(node), 0] = t
            shapes["var", node.name] = shapes[id(node), 0] = tuple(t.shape)
            dtypes["var", node.name] = dtypes[id(node), 0] = t.dtype

        for node in _topo(self._entries):
            if node.is_var:
                shape = shape_hints.get(node.name, node.attrs.get("__shape__"))
                if shape is not None and all(int(s) > 0 for s in shape):
                    put_var(node, shape, node.attrs.get("__dtype__"))
                continue
            data = next((vals.get((id(c), oi)) for c, oi in node.inputs
                         if (id(c), oi) in vals), None)
            rules = _custom_shape_rules(node, vals) if node.op == "Custom" \
                else _param_shape_rules(node, data)
            for child, _ in node.inputs:
                if (id(child), 0) in vals:
                    continue
                if child.is_var and child.name not in rules and \
                        child.name in fallback:
                    rules[child.name] = (fallback[child.name], None)
                if not (child.is_var and child.name in rules):
                    raise MXNetError(f"cannot infer the shape of input "
                                     f"{child.name!r} of {node.name!r} "
                                     f"({node.op})")
                shape, dtype = rules[child.name]
                put_var(child, shape, child.attrs.get("__dtype__", dtype))
            kwargs = _op_kwargs(node.attrs)
            if not node.inputs and "ctx" in inspect.signature(
                    _registry.get(node.op)).parameters:
                kwargs["ctx"] = meta   # a creation op: shapes only
            outs = _call(*_op(node.op),
                         [vals[id(c), oi] for c, oi in node.inputs],
                         kwargs, False)
            for i, o in enumerate(outs):
                vals[id(node), i] = o
                shapes[id(node), i] = tuple(o.shape)
                dtypes[id(node), i] = o.dtype
        return shapes, dtypes

    # --------------------------------------------------------------- eval --
    def _build_eval(self, update_aux=False):
        """The graph as one function ``run(args, auxs=None,
        training=False) -> [output tensors]`` over ``{name: tensor}``
        dicts. Each intermediate is dropped after its last consumer, so
        a forward holds about as much memory as the same ops run
        imperatively. With ``update_aux`` a training run writes each
        BatchNorm's running statistics (its auxiliary inputs) in place,
        ``old * momentum + batch * (1 - momentum)`` from the op's batch
        mean and biased variance, outside autograd: the executor's aux
        arrays keep their storage (the JAX ``_bn_aux_update``
        returns new arrays that its executor rebinds). While
        ``torch.profiler`` records, each node's op call runs inside a
        ``record_function("node:<name>")`` range, so a trace attributes
        the forward's kernels (and, by sequence number, the backward's)
        to graph nodes; otherwise that costs one flag read a run. While
        AMP is on (``amp.init``), each node's inputs are cast by its op's
        list (``_amp_core.cast_inputs``), as in the imperative path."""
        order = _topo(self._entries)
        heads = [(id(n), i) for n, i in self._entries]
        last_use = {}
        for step, node in enumerate(order):
            for c, oi in node.inputs:
                last_use[id(c), oi] = step
        steps = []
        for step, node in enumerate(order):
            ins = [(id(c), oi) for c, oi in node.inputs]
            done = {k for k in ins if last_use[k] == step
                    and k not in heads}
            op = (None, False) if node.is_var else _op(node.op)
            kwargs = _op_kwargs(node.attrs)
            stats = None
            if update_aux and node.op in _BATCH_NORMS and \
                    not kwargs.get("use_global_stats", False):
                stats = [(out, node.inputs[slot][0].name)
                         for out, slot in ((1, 3), (2, 4))
                         if node.inputs[slot][0].is_aux]
                stats = (kwargs.get("momentum", 0.9), stats)
            steps.append((node, op, kwargs, ins, done, stats))

        def run(args, auxs=None, training=False):
            vals = {}
            labelled = torch._C._autograd._profiler_enabled()
            amp = _amp_core.ACTIVE
            for node, op, kwargs, ins, done, stats in steps:
                if node.is_var:
                    vals[id(node), 0] = (auxs if node.is_aux and auxs
                                         is not None else args)[node.name]
                    continue
                inputs = [vals[k] for k in ins]
                if amp:
                    inputs = _amp_core.cast_inputs(node.op, inputs)
                if labelled:
                    with torch.profiler.record_function(
                            f"node:{node.name}"):
                        outs = _call(*op, inputs, kwargs, training)
                else:
                    outs = _call(*op, inputs, kwargs, training)
                for k in done:
                    del vals[k]
                for i, o in enumerate(outs):
                    vals[id(node), i] = o
                if training and stats is not None:
                    _bn_aux_update(stats, outs, auxs)
            return [vals[h] for h in heads]

        return run

    def eval_with(self, feed, param_feed=None, training=False):
        """Evaluate with ``{name: NDArray}`` feeds (inputs and
        parameters); returns one NDArray, or a list for several
        outputs."""
        from ..ndarray import NDArray

        raw = {k: v._data if isinstance(v, NDArray) else torch.as_tensor(v)
               for k, v in dict(feed, **(param_feed or {})).items()}
        missing = [n for n in self.list_inputs() if n not in raw]
        if missing:
            raise MXNetError(f"eval is missing inputs: {missing}")
        outs = [NDArray(o) for o in self._build_eval()(raw, raw, training)]
        return outs[0] if len(outs) == 1 else outs

    def eval(self, ctx=None, **kwargs):
        """Evaluate with the inputs as keywords; a list of NDArrays."""
        out = self.eval_with(kwargs)
        return out if isinstance(out, list) else [out]

    # --------------------------------------------------------------- bind --
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **shapes):
        """An :class:`~mxnet_tpu_torch.executor.Executor` over arrays
        of zeros on ``ctx`` (default: the current context), their shapes
        and types inferred from the given input ``shapes`` and
        ``type_dict``."""
        from ..executor import Executor

        ctx = _one_context(ctx)
        args, auxs = self._bind_arrays(ctx, shapes, type_dict or {})
        return Executor(self, ctx, args, auxs, grad_req)

    def _bind_arrays(self, ctx, shapes, type_dict, fallback=None):
        """``({arg name: zeros}, {aux name: zeros})`` on ``ctx``, shapes
        and types inferred from the hints; an input that neither a hint
        nor a layer rule sizes takes its ``fallback`` shape."""
        known, types = self._checked_infer(
            {k: tuple(v) for k, v in shapes.items()},
            {k: canonical_dtype(v) for k, v in type_dict.items()},
            fallback)
        _check_conv_dtypes(self._entries, types)
        device = ctx.torch_device()

        def alloc(names):
            out = {}
            for name in names:
                if ("var", name) not in known:
                    raise MXNetError(f"simple_bind: the shape of {name!r} "
                                     "is not known")
                out[name] = torch.zeros(known["var", name],
                                        dtype=types["var", name],
                                        device=device)
            return out

        return (alloc(self.list_arguments()),
                alloc(self.list_auxiliary_states()))

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None):
        """An Executor over the caller's arrays: ``args`` (and
        ``args_grad``, ``aux_states``) as lists in ``list_arguments()``
        (``list_auxiliary_states()``) order or as dicts by name. The
        executor computes in those arrays' storage."""
        from ..executor import Executor

        ctx = _one_context(ctx)
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()

        def by_name(values, names):
            if values is None:
                return {}
            if isinstance(values, (list, tuple)):
                return dict(zip(names, values))
            return {n: values[n] for n in names if n in values}

        args = by_name(args, arg_names)
        missing = [n for n in arg_names if n not in args]
        if missing:
            raise MXNetError(f"bind is missing arguments {missing}")
        return Executor(self, ctx, args, by_name(aux_states, aux_names),
                        grad_req, grad_arrays=by_name(args_grad, arg_names))

    # --------------------------------------------------------------- json --
    def tojson(self):
        order = _topo(self._entries)
        index = {id(n): i for i, n in enumerate(order)}
        nodes = []
        for n in order:
            entry = {"op": n.op or "null", "name": n.name,
                     "inputs": [[index[id(c)], oi, 0] for c, oi in n.inputs]}
            if n.attrs:
                entry["attrs"] = {k: _attr_str(v) for k, v in n.attrs.items()}
            nodes.append(entry)
        return json.dumps(
            {"nodes": nodes,
             "arg_nodes": [i for i, n in enumerate(order) if n.is_var],
             "heads": [[index[id(n)], i, 0] for n, i in self._entries],
             "attrs": {"mxnet_version": ["int", 10800],
                       "framework": ["str", "mxnet_tpu_torch"]}},
            indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())


def _check_conv_dtypes(entries, types):
    """Refuse, at bind, a convolution whose inputs differ in dtype (float32
    data into a bfloat16 graph), as the JAX package's graph verification
    does: ``lax.conv_general_dilated`` takes one dtype."""
    for node in _topo(entries):
        if node.op not in ("Convolution", "Deconvolution"):
            continue
        dts = [types[id(c), oi] for c, oi in node.inputs
               if (id(c), oi) in types]
        if len(set(dts)) > 1:
            raise MXNetError(
                f"graph verification failed: node {node.name!r} (op "
                f"{node.op}): its inputs must have one dtype, got "
                f"{', '.join(dtype_name(d) for d in dts)}")


def _one_context(ctx):
    """The one Context an executor runs on (default: the current one).
    A list of several is data parallelism over cards, which is not
    ported."""
    from ..context import current_context

    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError(f"an executor over {len(ctx)} contexts (data "
                             "parallelism over cards) is not ported yet; "
                             "see ROADMAP.md, multi-card data parallelism")
        ctx = ctx[0]
    return ctx if ctx is not None else current_context()


def _bn_aux_update(stats, outs, auxs):
    """Write a training BatchNorm's running statistics in place:
    ``stats`` is ``(momentum, [(output index, aux name)])``."""
    momentum, pairs = stats
    with torch.no_grad():
        for out, name in pairs:
            old = auxs[name]
            old.copy_(old * momentum
                      + outs[out].to(old.dtype) * (1 - momentum))


def _op(name):
    """Op ``name``'s function, and whether it takes the evaluator's
    ``training`` flag."""
    fn = _registry.get(name)
    return fn, "training" in inspect.signature(fn).parameters


def _call(fn, takes_training, inputs, kwargs, training):
    if takes_training:
        kwargs = dict(kwargs, training=training)
    out = fn(*inputs, **kwargs)
    return out if isinstance(out, (tuple, list)) else (out,)


def _param_shape_rules(node, data):
    """``{var name: (shape, dtype or None)}`` of the parameter inputs of
    ``node`` that follow from the shape of its data input ``data``."""
    if data is None:
        return {}
    dshape, attrs, rules = tuple(data.shape), node.attrs, {}

    def put(idx, shape, dtype=None):
        if idx < len(node.inputs) and node.inputs[idx][0].is_var:
            rules[node.inputs[idx][0].name] = (
                tuple(int(s) for s in shape), dtype)

    def in_units():
        if attrs.get("flatten", True):
            return int(torch.Size(dshape[1:]).numel())
        return dshape[-1]

    if node.op == "FullyConnected":
        put(1, (attrs["num_hidden"], in_units()))
        put(2, (attrs["num_hidden"],))
    elif node.op == "LayerNorm":
        for i in (1, 2):
            put(i, (dshape[attrs.get("axis", -1)],))
    elif node.op == "Embedding":
        put(1, (attrs["input_dim"], attrs["output_dim"]))
    elif node.op == "Convolution":
        kernel = tuple(attrs.get("kernel", ()))
        put(1, (attrs["num_filter"], dshape[1] // attrs.get("num_group", 1))
            + kernel)
        put(2, (attrs["num_filter"],))
    elif node.op == "Deconvolution":
        kernel = tuple(attrs.get("kernel", ()))
        put(1, (dshape[1], attrs["num_filter"] // attrs.get("num_group", 1))
            + kernel)
        put(2, (attrs["num_filter"],))
    elif node.op in ("GroupNorm", "InstanceNorm", "LeakyReLU"):
        for i in (1, 2):
            put(i, (dshape[1],))
    elif node.op == "RNN":
        put(1, (rnn_param_size(dshape[2], attrs["state_size"],
                               attrs.get("num_layers", 1),
                               attrs.get("mode", "lstm"),
                               attrs.get("bidirectional", False)),))
    elif node.op in _BATCH_NORMS:
        for i in (1, 2, 3, 4):
            put(i, (dshape[attrs.get("axis", 1)],), "float32")
    elif node.op in ("SoftmaxOutput", "SVMOutput"):
        # class-index labels: the data's shape without the class axis
        axis = 1 if attrs.get("multi_output", False) else len(dshape) - 1
        put(1, dshape[:axis] + dshape[axis + 1:])
    elif node.op in ("LinearRegressionOutput", "LogisticRegressionOutput",
                     "MAERegressionOutput"):
        put(1, dshape)
    elif node.op == "_contrib_quantized_fully_connected":
        put(1, (attrs["num_hidden"], in_units()), "int8")
        put(2, (attrs["num_hidden"],))
        put(3, (attrs["num_hidden"],))
    elif node.op == "_contrib_quantized_conv":
        kernel = tuple(attrs.get("kernel", ()))
        put(1, (attrs["num_filter"], dshape[1] // attrs.get("num_group", 1))
            + kernel, "int8")
        put(2, (attrs["num_filter"],))
        put(3, (attrs["num_filter"],))
    elif node.op == "_contrib_quantized_embedding":
        put(1, (attrs["input_dim"], attrs["output_dim"]), "int8")
        put(2, (1,))
        put(3, (1,))
    return rules


def _custom_shape_rules(node, vals):
    """The shapes a ``Custom`` node's prop infers for its variable inputs
    from the shapes known so far (an unknown one passed as ``[]``, as
    MXNet passes it)."""
    from ..ops.custom import _node_prop

    prop = _node_prop(_op_kwargs(node.attrs))
    known = [list(vals[id(c), oi].shape) if (id(c), oi) in vals else []
             for c, oi in node.inputs]
    n = len(prop.list_arguments())
    arg_shapes, _, aux_shapes = prop.infer_shape(known[:n])
    rules = {}
    for (child, _), shape in zip(node.inputs,
                                 list(arg_shapes) + list(aux_shapes)):
        if child.is_var and shape and all(int(d) > 0 for d in shape):
            rules[child.name] = (tuple(int(d) for d in shape), None)
    return rules


def _apply_op(op_name, args, kwargs):
    """Build an op node from Symbol inputs and static attributes (the
    composition step behind every ``mx.sym.<op>`` wrapper). Symbols fill
    the op's array arguments in signature order; missing parameters of
    layer ops (weights, biases, LayerNorm gains) become variables named
    ``<node>_<param>``."""
    from .. import name as _name

    op = _registry.canonical(op_name)
    kwargs = dict(kwargs)
    name = kwargs.pop("name", None)
    kwargs.pop("attr", None)
    pos_syms = iter([a for a in args if isinstance(a, Symbol)])
    sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
    static = {k: v for k, v in kwargs.items()
              if not isinstance(v, Symbol) and k not in _RUNTIME_PARAMS}
    # the op's schema checks and coerces the attributes here, at
    # construction (JAX :872-877); a copy, since node attributes change
    # later and the checked dict is the registry's cached one
    static = dict(_registry.checked(op, static))
    name = _name.current().get(name, op_name.lower().lstrip("_"))
    layer_params = _LAYER_PARAMS.get(op, {})
    inputs = []
    for p in _sig_params(_registry.get(op)):
        if p.kind is inspect.Parameter.VAR_KEYWORD:
            continue
        if p.kind is inspect.Parameter.VAR_POSITIONAL:
            declared = _registry.input_names(op)
            if declared is None:
                # *arrays (Concat, stack, add_n): every positional symbol
                inputs.extend(pos_syms)
                continue
            # an op whose hyper-parameters name its inputs (Custom): by
            # keyword or in order, a variable "<node>_<name>" for each
            # one not given (MXNet's "softmax_label")
            args_, auxs_ = declared(static)
            for arg in list(args_) + list(auxs_):
                given = sym_kwargs.pop(arg) if arg in sym_kwargs \
                    else next(pos_syms, None)
                inputs.append(given if given is not None else
                              var(f"{name}_{arg}", is_aux=arg in auxs_))
            continue
        if p.name in _RUNTIME_PARAMS or p.name in static:
            continue
        if p.name in sym_kwargs:
            inputs.append(sym_kwargs.pop(p.name))
            continue
        nxt = next(pos_syms, None)
        if nxt is not None:
            inputs.append(nxt)
        elif p.name in layer_params:
            suffix, skip, is_aux = layer_params[p.name]
            if skip is None or not skip(static):
                inputs.append(var(f"{name}_{suffix}", is_aux=is_aux))
        elif p.default is inspect.Parameter.empty:
            raise MXNetError(f"op {op!r} missing required input {p.name!r}")
        else:
            break
    left = list(pos_syms) + list(sym_kwargs)
    if left:
        raise MXNetError(f"op {op!r}: {len(left)} symbol inputs left over")
    n_out = _registry.num_outputs(op, len(inputs), static)
    scope = _attribute.current().get()
    if scope:   # AttrScope: dunder keys, never op parameters
        static = dict(scope, **static)
    node = _Node(op, name, static, [s._entries[0] for s in inputs], n_out)
    return Symbol([(node, i) for i in range(n_out)])


def var(name, attr=None, shape=None, dtype=None, init=None, is_aux=False,
        **kwargs):
    """A named graph input. ``attr`` and the active ``AttrScope``'s
    attributes are stored under dunder keys (the user's winning), and
    ``init`` as the ``__init__`` attribute (a name, or an initializer's
    ``repr``), as the JAX package keeps them."""
    attrs = _attribute.current().get(attr)
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else repr(init)
    if is_aux:
        attrs["__is_aux__"] = True
    attrs.update(kwargs)
    return Symbol([(_Node(None, name, attrs), 0)])


def Group(symbols):  # noqa: N802 - MXNet's name
    return Symbol([e for s in symbols for e in s._entries])


def load_json(json_str):
    """Rebuild a Symbol from graph JSON, the port's or the JAX
    package's. Ops the port does not have raise ``MXNetError``."""
    data = json.loads(json_str)
    raw_nodes = data["nodes"]
    built = []
    for rn in raw_nodes:
        attrs = {k: _parse_attr(v) for k, v in
                 (rn.get("attrs") or rn.get("param") or rn.get("attr")
                  or {}).items()}
        if rn["op"] == "null":
            built.append(_Node(None, rn["name"], attrs))
            continue
        try:
            op = _registry.canonical(rn["op"])
        except KeyError:
            raise MXNetError(f"node {rn['name']!r}: op {rn['op']!r} is not "
                             "ported") from None
        attrs = _coerce_attrs(op, attrs)
        # a bad attribute raises OpParamError here, at load (JAX :1009)
        clean = _registry.checked(
            op, {k: v for k, v in attrs.items() if not _is_dunder(k)})
        built.append(_Node(op, rn["name"], {**attrs, **clean}))
    for rn, node in zip(raw_nodes, built):
        node.inputs = [(built[i], oi) for i, oi, *_ in rn["inputs"]]
        if not node.is_var:
            node.num_outputs = _registry.num_outputs(
                node.op, len(node.inputs), _op_kwargs(node.attrs))
    heads = data.get("heads")
    entries = [(built[i], oi) for i, oi, *_ in heads] if heads \
        else [(built[-1], 0)]
    return Symbol(entries)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# ----------------------------------------------------- graph-pass registry

#: pass name (lower case) -> ``fn(symbol, args=None, aux=None, **kwargs)``
GRAPH_PASSES = {}


def register_pass(name):
    """Register a named graph pass for :meth:`Symbol.optimize_for`
    (counterpart of ``mxnet_tpu/symbol/symbol.py:1055``; MXNet 1.x's
    subgraph backends)."""
    def deco(fn):
        GRAPH_PASSES[name.lower()] = fn
        return fn

    return deco


def list_passes():
    return sorted(GRAPH_PASSES)


@register_pass("default")
def _default_pass(sym, args=None, aux=None, **kwargs):
    """The graph itself: no backend rewrites it."""
    return sym


@register_pass("amp")
def _amp_pass(sym, args=None, aux=None, target_dtype="bfloat16", **kwargs):
    """With parameters, ``amp.convert_model`` (which turns AMP on); the
    graph itself otherwise, as in the JAX package, whose casts happen
    when a graph runs, not in the graph."""
    if args is not None or aux is not None:
        from .. import amp

        return amp.convert_model(sym, args or {}, aux or {},
                                 target_dtype=target_dtype)[0]
    return sym


@register_pass("int8")
def _int8_pass(sym, args=None, aux=None, excluded_sym_names=(),
               ranges=None, **kwargs):
    """``contrib.quantization.quantize_graph``: ``(qsym, qspecs)``."""
    from ..contrib.quantization import quantize_graph

    return quantize_graph(sym, excluded_sym_names=excluded_sym_names,
                          ranges=ranges)
