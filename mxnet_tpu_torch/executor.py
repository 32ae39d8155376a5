"""Executor: a bound Symbol, its arrays, and its forward and backward.

Counterpart of ``mxnet_tpu/executor.py`` (MXNet 1.x
``python/mxnet/executor.py`` over ``GraphExecutor``). ``Symbol.
simple_bind`` allocates the arrays, ``Symbol.bind`` takes the caller's.

* ``forward(is_train, **feed)`` copies each fed array into its bound
  array, so every bound array keeps its storage from bind to the end,
  then runs the graph (``Symbol._build_eval``). A training forward
  records the graph for autograd over the arguments whose ``grad_req``
  is not ``"null"`` (leaves that share the bound storage, made once)
  and writes BatchNorm's running statistics into the aux arrays in
  place.
* ``backward(out_grads)`` runs ``torch.autograd.grad`` from the
  outputs (head gradients of ones when none are given: loss heads such
  as ``SoftmaxOutput`` ignore them) and copies the gradients into the
  bound gradient arrays (``"write"``) or adds them (``"add"``), one
  multi-tensor call each.

The JAX executor compiles ``fwd_train`` and its pullback (:130-173) under
the compile service's site ``executor``. Here both go through
``compile.jit`` under the site ``"executor"``: a training forward is a
``"pair"`` entry (its first call eager, then a forward graph and a
backward graph over the bound arrays, which ``backward`` replays through
``torch.autograd.grad``), an inference forward a ``"forward"`` entry (a
captured graph whose outputs are copied out). On the CPU both are plain
calls with the same keys; ``compile.set_enabled(False)`` runs them
eagerly. A symbol with a host node (``Custom``, a library op of
``mx.library.load``) is never captured: the compile service's host-op
rule runs both entries plainly from their first call on.
The entries read the bound arrays, whose storage never changes, so one
entry per mode serves every batch.
A context list of more than one card (data parallelism over cards)
raises :class:`MXNetError`: see ROADMAP.md, multi-card data
parallelism.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from . import compile as _compile
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Executor"]

_REQS = ("write", "add", "null")


def _tensor(value, device=None):
    t = value._data if isinstance(value, NDArray) else torch.as_tensor(value)
    return t.detach() if device is None else t.detach().to(device)


class Executor:
    """The arrays and the evaluator of one bound symbol."""

    def __init__(self, symbol, ctx, arg_arrays, aux_arrays, grad_req="write",
                 grad_arrays=None):
        self._symbol = symbol
        self._ctx = ctx
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self._arg_dict = OrderedDict(
            (n, _as_nd(arg_arrays[n])) for n in self.arg_names)
        self._aux_dict = OrderedDict(
            (n, _as_nd(aux_arrays[n])) for n in self.aux_names)
        self._grad_req = self._normalize_req(grad_req)
        grad_arrays = grad_arrays or {}
        self._grad_dict = OrderedDict()
        for name in self.arg_names:
            if self._grad_req[name] == "null":
                continue
            given = grad_arrays.get(name)
            self._grad_dict[name] = _as_nd(given) if given is not None \
                else NDArray(torch.zeros_like(self._arg_dict[name]._data))
        self._run = symbol._build_eval(update_aux=True)
        self._graph = None     # (outputs, {name: leaf}) of a train forward
        self._leaves = {}      # name -> (bound tensor, its gradient leaf)
        self._fwd_train = _compile.jit(
            self._train_body, site="executor", token=("fwd_train", id(self)),
            reads=self._train_reads, kind="pair")
        self._fwd = _compile.jit(
            self._infer_body, site="executor", token=("fwd", id(self)),
            reads=self._bound)
        self.outputs = []

    def _normalize_req(self, grad_req):
        if isinstance(grad_req, str):
            req = dict.fromkeys(self.arg_names, grad_req)
        elif isinstance(grad_req, (list, tuple)):
            req = dict(zip(self.arg_names, grad_req))
        else:
            req = dict.fromkeys(self.arg_names, "null")
            req.update(grad_req)
        bad = {n: r for n, r in req.items() if r not in _REQS}
        if bad:
            raise MXNetError(f"grad_req must be one of {_REQS}, got {bad}")
        return req

    # ------------------------------------------------------------ forward --
    def forward(self, is_train=False, **kwargs):
        """Copy each keyword array into the bound argument of that name,
        run the graph and return the outputs (NDArrays)."""
        for name, value in kwargs.items():
            dst = self._arg_dict.get(name)
            if dst is None:
                raise MXNetError(f"unknown argument {name!r}")
            src = _tensor(value)
            if tuple(src.shape) != dst.shape:
                raise MXNetError(f"shape mismatch for {name!r}: bound "
                                 f"{dst.shape}, fed {tuple(src.shape)}")
            with torch.no_grad():
                dst._data.copy_(src)
        self._graph = None   # drop the last step's graph before this one
        diff = self._diff()
        if is_train and diff:
            with torch.enable_grad():
                outs = self._fwd_train()
            self._graph = (outs, {n: self._leaf(n) for n in diff})
        elif is_train:
            with torch.no_grad():
                outs = self._fwd_train()
        else:
            with torch.no_grad():
                outs = self._fwd()
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def _diff(self):
        return [n for n in self.arg_names if self._grad_req[n] != "null"]

    def _leaf(self, name):
        """The gradient leaf of argument ``name``: a view of its bound
        tensor that requires grad, made once (and again only if the
        bound array was rebound)."""
        base = self._arg_dict[name]._data
        got = self._leaves.get(name)
        if got is None or got[0] is not base:
            got = self._leaves[name] = (base,
                                        base.detach().requires_grad_(True))
        return got[1]

    def _bound(self):
        return [a._data for a in self._arg_dict.values()] + \
            [a._data for a in self._aux_dict.values()]

    def _train_reads(self):
        diff = self._diff()
        return [self._leaf(n) for n in diff] + [
            self._arg_dict[n]._data for n in self.arg_names
            if n not in set(diff)] + [a._data for a in self._aux_dict.values()]

    def _train_body(self):
        """The training forward over the bound arrays, the differentiable
        arguments as their leaves; the statistics written in place."""
        args = {n: a._data for n, a in self._arg_dict.items()}
        args.update((n, self._leaf(n)) for n in self._diff())
        auxs = {n: a._data for n, a in self._aux_dict.items()}
        return self._run(args, auxs, True)

    def _infer_body(self):
        args = {n: a._data for n, a in self._arg_dict.items()}
        auxs = {n: a._data for n, a in self._aux_dict.items()}
        return self._run(args, auxs, False)

    # ----------------------------------------------------------- backward --
    def backward(self, out_grads=None):
        """Gradients of the last training forward into the bound
        gradient arrays, by each argument's ``grad_req``."""
        if not self._grad_dict:
            return
        if self._graph is None:
            raise MXNetError("backward needs a forward(is_train=True) "
                             "before it")
        outs, leaves = self._graph
        self._graph = None
        if out_grads is None:
            cots = [torch.ones_like(o) for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            cots = [_tensor(g, o.device) for g, o in zip(out_grads, outs)]
        pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        names = list(leaves)
        grads = torch.autograd.grad([o for o, _ in pairs],
                                    [leaves[n] for n in names],
                                    [c for _, c in pairs],
                                    allow_unused=True) if pairs \
            else [None] * len(names)
        write, add = ([], []), ([], [])
        with torch.no_grad():
            for name, g in zip(names, grads):
                dst = self._grad_dict[name]._data
                if g is None:
                    if self._grad_req[name] == "write":
                        dst.zero_()
                    continue
                to = add if self._grad_req[name] == "add" else write
                to[0].append(dst)
                to[1].append(g)
            if write[0]:
                torch._foreach_copy_(*write)
            if add[0]:
                torch._foreach_add_(*add)

    # ------------------------------------------------------------- access --
    @property
    def arg_dict(self):
        return self._arg_dict

    @property
    def grad_dict(self):
        return self._grad_dict

    @property
    def aux_dict(self):
        return self._aux_dict

    @property
    def output_dict(self):
        return OrderedDict(zip(self.output_names, self.outputs))

    @property
    def arg_arrays(self):
        return list(self._arg_dict.values())

    @property
    def grad_arrays(self):
        return [self._grad_dict.get(n) for n in self.arg_names]

    @property
    def aux_arrays(self):
        return list(self._aux_dict.values())

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy ``{name: array}`` values into the bound arrays (in place,
        in each bound array's dtype)."""
        for params, bound, what in ((arg_params, self._arg_dict, "arg"),
                                    (aux_params or {}, self._aux_dict,
                                     "aux")):
            for name, value in params.items():
                dst = bound.get(name)
                if dst is None:
                    if not allow_extra_params:
                        raise MXNetError(f"{what} {name!r} is not bound")
                    continue
                with torch.no_grad():
                    dst._data.copy_(_tensor(value))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **shapes):
        """A new executor for new input shapes. Arrays whose shape stays
        are shared with this one (as MXNet shares their memory); the
        others are new zeros. As in MXNet, an array that was not named in
        ``shapes`` may change shape only with ``partial_shaping``, and one
        may grow past its old size only with ``allow_up_sizing``."""
        types = {n: a.dtype for n, a in self._arg_dict.items()}
        types.update((n, a.dtype) for n, a in self._aux_dict.items())
        args, auxs = self._symbol._bind_arrays(
            self._ctx, shapes, types,
            fallback={n: a.shape for n, a in self._arg_dict.items()})
        for mine, theirs in ((self._arg_dict, args), (self._aux_dict, auxs)):
            for name, arr in mine.items():
                shape = tuple(theirs[name].shape)
                if shape == arr.shape:
                    continue
                if name not in shapes and not partial_shaping:
                    raise MXNetError(
                        f"reshape: the shape of {name!r}, which was not "
                        f"given, changes from {arr.shape} to {shape}; pass "
                        "partial_shaping=True if that is intended")
                if theirs[name].numel() > arr.size and not allow_up_sizing:
                    raise MXNetError(
                        f"reshape: {name!r} grows from {arr.shape} to "
                        f"{shape}; pass allow_up_sizing=True to allocate "
                        "the larger array")
        new = Executor(self._symbol, self._ctx, args, auxs, self._grad_req)
        for mine, theirs in ((self._arg_dict, new._arg_dict),
                             (self._aux_dict, new._aux_dict),
                             (self._grad_dict, new._grad_dict)):
            for name, arr in mine.items():
                if theirs[name].shape == arr.shape:
                    theirs[name] = arr
        return new


def _as_nd(value):
    return value if isinstance(value, NDArray) else NDArray(value)
