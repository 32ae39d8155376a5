"""Gluon Block / HybridBlock / SymbolBlock.

Counterpart of ``mxnet_tpu/gluon/block.py``: name scopes and prefixes,
child and parameter registration by attribute assignment,
``collect_params`` and the structural (attribute-path) parameter names
of ``_collect_params_with_structure``.

``HybridBlock.hybridize()`` (JAX :231-300) attaches a
:class:`~mxnet_tpu_torch.cached_op.CachedOp` at the next call: on a CUDA
card each input signature's inference forward is captured into one CUDA
graph and replayed, and a call under ``autograd.record()`` or in
training mode into a forward graph and a backward graph that one
``autograd.Function`` replays (``compile.py``, site ``"cachedop"``); on
the CPU it is a plain call with the same keys. It stays eager for the
first call of a block whose parameter shapes are deferred (as in JAX;
here its children too, where the JAX package compiles the ones that
have no deferred parameters), inside an outer capture (the child runs
into the parent's graph) and when ``compile.set_enabled(False)``.

A HybridBlock called on a Symbol traces its ``hybrid_forward`` over the
``mx.sym`` namespace into a graph (:301-315); ``export`` (:332) writes
that graph and the parameters as ``prefix-symbol.json`` +
``prefix-0000.params``, and ``SymbolBlock`` (:358) runs such a graph as
a block, ``SymbolBlock.imports`` (:385) loading the pair back.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

from .. import compile as _compile
from ..cached_op import CachedOp
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """Name-scope manager: children created inside ``with
    block.name_scope():`` get prefixes under the block's prefix."""

    _tls = threading.local()

    def __init__(self, block):
        # made anew by each name_scope(), alive only inside its ``with``:
        # a block holding its scope would make a reference cycle and wait
        # for the cyclic collector (and with it a hybridized block's
        # graph pools); the child counters live on the block
        self._block = block
        self._counter = block._scope_counter
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """Prefix and ParameterDict for a new Block."""
        current = getattr(_BlockScope._tls, "value", None)
        if current is None:
            if prefix is None:
                counters = _BlockScope._top_counters()
                count = counters.get(hint, 0)
                counters[hint] = count + 1
                prefix = f"{hint}{count}_"
            params = ParameterDict(prefix) if params is None else \
                ParameterDict(params.prefix, shared=params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            params = ParameterDict(current._block.params.prefix + prefix)
        else:
            params = ParameterDict(params.prefix, shared=params)
        return current._block.prefix + prefix, params

    @staticmethod
    def _top_counters():
        counters = getattr(_BlockScope._tls, "top", None)
        if counters is None:
            counters = _BlockScope._tls.top = {}
        return counters

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._tls, "value", None)
        _BlockScope._tls.value = self
        return self

    def __exit__(self, *exc):
        if self._block._empty_prefix:
            return
        _BlockScope._tls.value = self._old_scope


class Block:
    """Base container for layers and models."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope_counter = {}
        self._children = OrderedDict()
        self._reg_params = OrderedDict()

    def _alias(self):
        return self.__class__.__name__.lower()

    def __setattr__(self, name, value):
        """Registers Parameters and child Blocks."""
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and not isinstance(
                    value, type(existing)) \
                    and not isinstance(existing, type(value)):
                raise TypeError(f"Changing attribute type for {name} from "
                                f"{type(existing)} to {type(value)} is not "
                                "allowed")
        if isinstance(value, Block):
            self._children[name] = value
        elif isinstance(value, Parameter):
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block
        return block

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return _BlockScope(self)

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None) -> ParameterDict:
        """Parameters of this block and its descendants, optionally
        filtered by a regex on the full name."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pattern = re.compile(select)
            ret.update({k: v for k, v in self._params.items()
                        if pattern.match(k)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def initialize(self, init=None, ctx=None, generator=None,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (default: the current
        context, the card unless a ``with mx.cpu():`` says otherwise),
        drawing from the CPU ``torch.Generator`` ``generator``."""
        self.collect_params().initialize(init, ctx, generator, force_reinit)

    def cast(self, dtype):
        """Cast every parameter of this block and its children to
        ``dtype`` (a layer may keep some in another type: BatchNorm)."""
        for child in self._children.values():
            child.cast(dtype)
        for p in self._params.values():
            p.cast(dtype)

    def _collect_params_with_structure(self, prefix=""):
        """Parameters by structural (attribute-path) name, e.g.
        ``encoder.1.attn.query.weight``; independent of name counters."""
        ret = OrderedDict()
        for name, p in self._reg_params.items():
            ret[prefix + name] = p
        for cname, child in self._children.items():
            ret.update(child._collect_params_with_structure(
                prefix + cname + "."))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Write the parameters to ``filename`` in the ``nd.save``
        container, keyed by structural name, so a block of any prefix
        (and the JAX package's ``load_parameters``) reads them back (JAX
        ``gluon/block.py:158-164``)."""
        from ..ndarray import utils as nd_utils

        nd_utils.save(filename, {
            name: p.data() for name, p in
            self._collect_params_with_structure().items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False):
        """Read a :meth:`save_parameters` file (this package's or the JAX
        package's) into the parameters, each keeping its device (JAX
        :166-181)."""
        from ..context import cpu
        from ..ndarray import utils as nd_utils

        loaded = nd_utils.load(filename, ctx=cpu())
        params = self._collect_params_with_structure()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise ValueError(f"Parameter {name!r} missing in "
                                     f"{filename!r}")
        for name, value in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise ValueError(f"Parameter {name!r} in file is not "
                                     "in Block")
                continue
            params[name].set_data(value)

    def hybridize(self, active=True, **kwargs):
        """Hybridize the children (MXNet 1.x ``Block.hybridize``): a
        plain Block runs its own forward eagerly, its HybridBlock
        children captured."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError

    def __repr__(self):
        s = f"{type(self).__name__}(\n"
        for name, child in self._children.items():
            s += f"  ({name}): {child!r}\n".replace("\n", "\n  ")[2:] + "\n"
        return s + ")"


class HybridBlock(Block):
    """A Block whose forward is written once as ``hybrid_forward(F, x,
    *args, **params)`` over the ``F`` op namespace."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None

    def hybridize(self, active=True, **kwargs):
        """Turn captured execution on (or off) for this block and its
        children, dropping any cached op. ``static_alloc`` and
        ``static_shape`` are accepted and change nothing: a CUDA graph
        always runs on static memory and shapes."""
        self._active = active
        self._cached_op = None
        for child in self._children.values():
            if isinstance(child, HybridBlock):
                child.hybridize(active, **kwargs)

    def _clear_cached_op(self):
        self._cached_op = None
        for child in self._children.values():
            if isinstance(child, HybridBlock):
                child._clear_cached_op()

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def __call__(self, *args):
        from ..symbol import Symbol

        if any(isinstance(a, Symbol) for a in args):
            return self.forward(*args)  # tracing a graph
        if self._active and not _compile.inside():
            if self._cached_op is not None:  # hot path: no tree walk
                return self._cached_op(*args)
            tree_params = self.collect_params()
            if any(p._data is None for p in tree_params.values()):
                # the first call resolves deferred shapes eagerly, children
                # included (one without parameters would capture itself);
                # capture from the next call
                with _compile.nested():
                    return self.forward(*args)
            self._build_cache(tree_params)
            return self._cached_op(*args)
        return self.forward(*args)

    def _build_cache(self, tree_params):
        """JAX :290-300: this block's forward as a CachedOp over its
        tree's parameters."""
        self._cached_op = CachedOp(self.forward, list(tree_params.values()))

    def infer_shape(self, *args):
        """Resolve deferred parameter shapes from the inputs; layers
        whose parameter shapes depend on the input override this."""
        raise ValueError(
            f"{type(self).__name__} has parameters with unknown shape. "
            "Override infer_shape or provide in_units/in_channels.")

    def _materialize_params(self, *args):
        try:
            return {name: p.data() for name, p in self._reg_params.items()}
        except DeferredInitializationError:
            self.infer_shape(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            return {name: p.data() for name, p in self._reg_params.items()}

    def forward(self, x, *args):
        """NDArrays run ``hybrid_forward`` over ``mx.nd``; a Symbol input
        traces it over ``mx.sym``, the parameters as graph variables."""
        from .. import symbol

        if isinstance(x, symbol.Symbol):
            params = {name: p.var() for name, p in self._reg_params.items()}
            return self.hybrid_forward(symbol, x, *args, **params)
        from .. import ndarray as F

        params = self._materialize_params(x, *args)
        return self.hybrid_forward(F, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _trace_symbol(self, input_names=("data",)):
        """This block's forward as a graph over inputs ``input_names``."""
        from .. import symbol

        out = self.forward(*[symbol.var(n) for n in input_names])
        if isinstance(out, (list, tuple)):
            out = symbol.Group(list(out))
        return out

    def export(self, path, epoch=0, input_names=("data",)):
        """Write ``path-symbol.json`` and ``path-%04d.params`` (tagged
        ``arg:``/``aux:``), loadable by :meth:`SymbolBlock.imports`,
        ``model.load_checkpoint`` and the JAX package. Returns the
        graph. Run one forward first when shapes were deferred."""
        from ..ndarray import utils as nd_utils

        sym = self._trace_symbol(input_names)
        sym.save(f"{path}-symbol.json")
        args = set(sym.list_arguments())
        auxs = set(sym.list_auxiliary_states())
        save_dict = {}
        for name, param in self.collect_params().items():
            if name in args:
                save_dict[f"arg:{name}"] = param.data()
            elif name in auxs:
                save_dict[f"aux:{name}"] = param.data()
        nd_utils.save(f"{path}-{epoch:04d}.params", save_dict)
        return sym

    def optimize_for(self, x, *args, backend=None, **kwargs):
        """Hybridize and run ``x`` through the block, as the JAX package
        does (``mxnet_tpu/gluon/block.py:353``): no backend rewrites a
        block's graph, the captured forward is its optimized form."""
        self.hybridize()
        return self(x, *args)


class SymbolBlock(HybridBlock):
    """A Symbol graph run as a block: each argument or auxiliary state
    of the graph that is not an input becomes a Parameter (auxiliary
    states not differentiable)."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from .. import symbol

        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self._sb_inputs = [i if isinstance(i, symbol.Symbol)
                           else symbol.var(str(i)) for i in inputs]
        self._sb_outputs = outputs
        input_names = {s.name for s in self._sb_inputs}
        for name in outputs.list_arguments():
            if name not in input_names:
                self.params.get(name, allow_deferred_init=True)
        for name in outputs.list_auxiliary_states():
            if name not in input_names:
                self.params.get(name, grad_req="null",
                                allow_deferred_init=True,
                                differentiable=False)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A block over an ``export``-ed (or ``save_checkpoint``-ed)
        graph; the parameters from ``param_file`` on ``ctx`` (default:
        the current context)."""
        from .. import symbol

        sym = symbol.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        block = SymbolBlock(sym, [symbol.var(n) for n in input_names])
        if param_file:
            params = block.collect_params()
            params.initialize(ctx=ctx)
            params.load(param_file, ctx=ctx, allow_missing=False,
                        ignore_extra=True)
        return block

    @property
    def symbol(self):
        return self._sb_outputs

    def infer_shape(self, *args):
        """Deferred parameter shapes from the input shapes, by the
        graph's shape inference."""
        names = [s.name for s in self._sb_inputs]
        shapes = self._sb_outputs._infer(
            {n: tuple(a.shape) for n, a in zip(names, args)})
        for name, p in self.collect_params().items():
            got = shapes.get(("var", name))
            if got is not None and (p.shape is None or
                                    any(s == 0 for s in p.shape)):
                p.shape = got

    def forward(self, *args):
        params = self.collect_params()
        try:
            feed = {name: p.data() for name, p in params.items()}
        except DeferredInitializationError:
            self.infer_shape(*args)
            for p in params.values():
                p._finish_deferred_init()
            feed = {name: p.data() for name, p in params.items()}
        feed.update(zip([s.name for s in self._sb_inputs], args))
        return self._sb_outputs.eval_with(feed)
