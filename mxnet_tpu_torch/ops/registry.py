"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``. An op is a plain function
on ``torch.Tensor`` arguments, ``fn(*tensors, **hyper_parameters)``,
registered under its MXNet name with its number of outputs. The
``nd.<op>`` / ``F.<op>`` wrappers, ``F.invoke(name, ...)``
(``ndarray/__init__.py``) and the ``mx.sym.<op>`` graph composers
(``symbol/__init__.py``) are generated from this table.

* ``num_outputs``: an int, or a callable ``(n_inputs, kwargs) -> int``
  for ops whose output count follows their hyper-parameters
  (``SliceChannel``, ``split_v2``), as in the JAX registry.
* ``differentiable=False``: the op's outputs are detached, so nothing
  recorded flows back through it (``argmax``, ``argsort``, ``topk``, the
  creation ops), as the JAX ``Operator`` keeps such ops off its tape.
* ``host=True``: the op waits on the host in the middle of a graph,
  which a CUDA graph cannot hold: it runs user code on host copies of
  its inputs (``Custom``, the ops of a library that ``mx.library.load``
  registered) or reads a solver's status back (``linalg_syevd``). The
  JAX registry's ``eager=True`` plays this part there.
  Each call of such an op is noted on its thread while a
  :func:`watching_host_ops` scope is open (the compile service's first
  calls), so the service runs that body uncaptured; one called while
  the current stream captures raises :class:`HostOpInCapture`.
* ``input_names``: a callable ``(hyper-parameters) -> (argument names,
  auxiliary state names)`` for an op of ``*arrays`` whose inputs follow
  its hyper-parameters (``Custom``): the symbol layer takes keyword
  Symbol inputs by these names and makes a variable ``<node>_<name>``
  for each one not given.
* ``param_specs``: ``{param: ParamSpec | dict}`` enriching the schema
  that ``ops/schema.py`` derives from the function's signature (range,
  choices, doc). :func:`checked` validates and string-coerces an op's
  keywords against it, once per distinct keyword set (a cache on the
  frozen keywords, JAX ``ops/registry.py:90-122``); ``ndarray._invoke``
  and the symbol layer call it, so a misspelt keyword raises
  :class:`~.schema.OpParamError` at the call or at node construction.
  :func:`op` gives the JAX ``Operator``'s view (``schema``,
  ``checked``, ``check_kwargs``) and :func:`op_schemas` the dump.
* A name that is not registered raises :class:`OpNotPorted`, an
  ``MXNetError`` (and a ``KeyError``) naming it with a "did you mean".
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict

import torch

from ..base import MXNetError

__all__ = ["register", "get", "canonical", "list_ops", "aliases",
           "num_outputs", "differentiable", "input_names", "op", "Op",
           "alias", "is_host",
           "checked", "op_schemas", "watching_host_ops", "OpNotPorted",
           "HostOpInCapture"]

_REGISTRY: Dict[str, Callable] = {}
_ALIASES: Dict[str, tuple] = {}
_CANONICAL: Dict[str, str] = {}
_NUM_OUTPUTS: Dict[str, object] = {}
_NON_DIFF: set = set()
_INPUT_NAMES: Dict[str, Callable] = {}
_PARAM_SPECS: Dict[str, dict] = {}
_FUNCS: Dict[str, Callable] = {}     # name -> the function as written
_HOST: set = set()
_SCHEMAS: Dict[str, object] = {}
_CHECK_CACHE: Dict[str, dict] = {}
_CHECK_CACHE_SIZE = 4096   # entries an op keeps before it starts again
_tls = threading.local()


class OpNotPorted(MXNetError, KeyError):
    """The op is not in the port's registry."""

    def __str__(self):
        return self.args[0]


class HostOpInCapture(MXNetError, RuntimeError):
    """A host op was called while a CUDA graph captured."""


@contextlib.contextmanager
def watching_host_ops():
    """Within the scope, each host op called on this thread appends its
    description (``"Custom(op_type='softmax')"``, ``"my_relu"``) to the
    list the scope yields; scopes nest, and an outer one sees what an
    inner one saw."""
    seen = []
    stack = getattr(_tls, "watch", None)
    if stack is None:
        stack = _tls.watch = []
    stack.append(seen)
    try:
        yield seen
    finally:
        stack.pop()


def _host_op(name, fn):
    @functools.wraps(fn)
    def op(*args, **kwargs):
        what = name if "op_type" not in kwargs else \
            f"{name}(op_type={kwargs['op_type']!r})"
        if any(getattr(a, "is_cuda", False) for a in args):
            import torch

            if torch.cuda.is_current_stream_capturing():
                raise HostOpInCapture(
                    f"host op {what} was called inside a CUDA graph "
                    "capture: its body reads its inputs on the host, so "
                    "the graph that holds it runs uncaptured (the compile "
                    "service decides so from the body's first call)")
        for seen in getattr(_tls, "watch", ()):
            if what not in seen:
                seen.append(what)
        return fn(*args, **kwargs)

    return op


def _detached(fn):
    @functools.wraps(fn)
    def op(*args, **kwargs):
        out = fn(*args, **kwargs)
        if isinstance(out, (tuple, list)):
            return type(out)(o.detach() for o in out)
        return out.detach()

    return op


def register(name: str, aliases=(), num_outputs=1, differentiable=True,
             host=False, input_names=None, param_specs=None):
    """Decorator: register ``fn`` as op ``name`` (and its aliases); it
    returns a tuple of ``num_outputs`` tensors when that is above 1 (or
    is a callable). Returns ``fn`` itself."""

    def deco(fn: Callable) -> Callable:
        _FUNCS[name] = fn
        if param_specs is not None:
            _PARAM_SPECS[name] = param_specs
        op = fn if differentiable else _detached(fn)
        if host:
            op = _host_op(name, op)
            _HOST.add(name)
        if input_names is not None:
            _INPUT_NAMES[name] = input_names
        _REGISTRY[name] = op
        _ALIASES[name] = tuple(aliases)
        _NUM_OUTPUTS[name] = num_outputs if callable(num_outputs) \
            else int(num_outputs)
        if not differentiable:
            _NON_DIFF.add(name)
        for n in (name,) + tuple(aliases):
            _REGISTRY[n] = op
            _CANONICAL[n] = name
        return fn

    return deco


def alias(new: str, existing: str):
    """Register op ``new`` as a second name of op ``existing``, with its
    outputs, gradient and host flags (JAX ``numpy_ops._alias``): a name
    of its own in :func:`list_ops`, as there."""
    old = canonical(existing)
    register(new, num_outputs=_NUM_OUTPUTS[old],
             differentiable=old not in _NON_DIFF, host=old in _HOST,
             input_names=_INPUT_NAMES.get(old),
             param_specs=_PARAM_SPECS.get(old))(_FUNCS[old])


def is_host(name: str) -> bool:
    return canonical(name) in _HOST


def get(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        from ..base import did_you_mean

        raise OpNotPorted(f"operator {name!r} is not registered "
                          f"({len(_ALIASES)} ops available)"
                          f"{did_you_mean(name, _REGISTRY, n=3)}") from None


def canonical(name: str) -> str:
    """The registered name of op ``name`` or of the op it aliases."""
    get(name)
    return _CANONICAL[name]


def list_ops():
    """Registered op names (without aliases), sorted."""
    return sorted(_ALIASES)


def aliases(name: str) -> tuple:
    return _ALIASES[name]


def num_outputs(name: str, n_inputs=0, kwargs=None) -> int:
    """The op's number of outputs for a node with ``n_inputs`` inputs and
    the hyper-parameters ``kwargs``."""
    n = _NUM_OUTPUTS[canonical(name)]
    if callable(n):
        n = n(n_inputs, dict(kwargs or {}))
    return int(n) or 1


def differentiable(name: str) -> bool:
    return canonical(name) not in _NON_DIFF


def input_names(name: str):
    """Op ``name``'s ``input_names`` callable, or None."""
    return _INPUT_NAMES.get(canonical(name))


# ------------------------------------------------------------ schemas ----

def _freeze(value):
    """Keywords made hashable, as the cache key (JAX :24-36). A tensor
    or an array handle raises TypeError, as an unhashable JAX array does:
    keyed by identity, it would keep every tensor alive in the cache."""
    if isinstance(value, torch.Tensor) or hasattr(value, "_data"):
        raise TypeError("an array keyword is not a cache key")
    if isinstance(value, dict):
        if len(value) == 1:
            ((k, v),) = value.items()
            return ((k, _freeze(v)),)
        return tuple(sorted((k, _freeze(v)) for k, v in value.items()))
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, set):
        return tuple(sorted(_freeze(v) for v in value))
    return value


def schema(name: str):
    """Op ``name``'s :class:`~.schema.OpSchema`, derived from its
    function's signature and ``param_specs`` at first use."""
    key = canonical(name)
    hit = _SCHEMAS.get(key)
    if hit is None:
        from .schema import OpSchema

        hit = _SCHEMAS[key] = OpSchema.from_fn(key, _FUNCS[key],
                                               _PARAM_SPECS.get(key))
    return hit


def checked(name: str, kwargs: dict) -> dict:
    """``kwargs`` validated and coerced for op ``name`` (raises
    :class:`~.schema.OpParamError`). The result is cached per frozen
    keyword set and shared: treat it as read-only. Keywords that do not
    hash (a tensor) are validated without the cache."""
    if not kwargs:
        return kwargs
    cache = _CHECK_CACHE.get(name)
    if cache is None:
        cache = _CHECK_CACHE[name] = {}
    try:
        key = _freeze(kwargs)
        hit = cache.get(key)
    except TypeError:
        return schema(name).validate(kwargs)
    if hit is None:
        if len(cache) >= _CHECK_CACHE_SIZE:   # keywords that vary per call
            cache.clear()
        hit = cache[key] = schema(name).validate(kwargs)
    return hit


class Op:
    """The JAX ``Operator``'s view of a registered op: its function,
    ``schema``, ``checked`` and ``check_kwargs``."""

    def __init__(self, name):
        self.name = canonical(name)
        self.fn = get(name)

    @property
    def schema(self):
        return schema(self.name)

    def check_kwargs(self, kwargs: dict) -> dict:
        return checked(self.name, kwargs)

    def checked(self, kwargs: dict):
        """``(validated kwargs, frozen key)``; the key is None for
        keywords that do not hash (JAX :90-108)."""
        out = checked(self.name, kwargs)
        if not kwargs:
            return out, ()
        try:
            return out, _freeze(kwargs)
        except TypeError:
            return out, None

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __repr__(self):
        return f"Operator({self.name})"


def op(name: str) -> Op:
    return Op(name)


def op_schemas():
    """``{op name: schema dict}`` for every registered op (JAX
    :258-262)."""
    return {name: schema(name).describe() for name in list_ops()}
