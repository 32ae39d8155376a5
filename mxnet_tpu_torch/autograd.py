"""Autograd scopes and the imperative backward.

Counterpart of ``mxnet_tpu/autograd.py``: the thread-local recording and
training flags (``is_recording`` :40, ``is_training``), the ``record`` /
``pause`` / ``train_mode`` / ``predict_mode`` scopes, ``backward`` (:189)
and ``grad`` (:365), ``mark_variables`` (:402), ``get_symbol`` (:433) and
``Function`` (:439). The JAX package keeps its own tape; here the tape is
``torch.autograd``. ``record()`` turns PyTorch's grad mode on for the
scope and ``pause()`` turns it off, so what is computed outside a
recording builds no graph (MXNet semantics). Serving runs its forward
under ``pause(train_mode=False)`` inside ``torch.inference_mode()``.

Leaves are NDArrays with ``attach_grad()`` and, under ``record()``, the
leaf views that trainable Parameters hand out (``gluon/parameter.py``).
``backward`` finds the leaves a head depends on by walking its
``grad_fn`` graph, writes each leaf's gradient into the leaf's own buffer
(``grad_req="write"``) or adds to it (``"add"``), and marks it fresh for
``gluon.Trainer``'s stale-gradient check. ``mark_variables`` makes
leaves whose gradient buffers the caller supplies.

A :class:`Function` is one ``torch.autograd.Function`` node: its
``forward`` runs the user's ``forward`` on NDArrays under :func:`pause`,
and its ``backward`` the user's ``backward`` with the output gradients
as NDArrays.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward",
           "grad", "mark_variables", "get_symbol", "Function"]

_tls = threading.local()


def is_recording() -> bool:
    return getattr(_tls, "recording", False)


def is_training() -> bool:
    return getattr(_tls, "training", False)


def is_recomputing() -> bool:
    """Whether this thread is recomputing a checkpointed forward in its
    backward (``ShardedTrainer``'s ``remat``): state written by a forward
    (BatchNorm's running statistics) was written the first time."""
    return getattr(_tls, "recomputing", False)


def set_recomputing(on: bool) -> bool:
    """Set the flag on this thread; returns the previous value."""
    prev = is_recomputing()
    _tls.recomputing = bool(on)
    return prev


def set_recording(is_record: bool) -> bool:
    """Set the flag on this thread; returns the previous value."""
    prev = is_recording()
    _tls.recording = bool(is_record)
    return prev


def set_training(train: bool) -> bool:
    """Set the flag on this thread; returns the previous value."""
    prev = is_training()
    _tls.training = bool(train)
    return prev


class _RecordingStateScope:
    """Sets the recording flag (and PyTorch's grad mode with it) and the
    training flag for the scope; None leaves a flag as it is."""

    def __init__(self, is_record, train):
        self._record = is_record
        self._train = train
        self._prev = None

    def __enter__(self):
        self._prev = (is_recording(), is_training(),
                      torch.is_grad_enabled())
        if self._record is not None:
            set_recording(self._record)
            torch.set_grad_enabled(self._record)
        if self._train is not None:
            set_training(self._train)
        return self

    def __exit__(self, *exc):
        recording, training, grad_mode = self._prev
        set_recording(recording)
        set_training(training)
        torch.set_grad_enabled(grad_mode)


def record(train_mode: bool = True):
    """Scope whose operations are recorded for ``backward``."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    """Scope that records nothing, with the training flag set to
    ``train_mode``."""
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def _leaves(heads):
    """The leaf tensors (``attach_grad`` arrays) the heads depend on."""
    found, seen = [], set()
    stack = [h.grad_fn for h in heads if h.grad_fn is not None]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)   # AccumulateGrad: a leaf
        if var is not None:
            found.append(var)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return found


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Reverse pass from ``heads`` (NDArrays): each leaf array they
    depend on gets its gradient written (``grad_req="write"``) or added
    (``"add"``)."""
    from .ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    tensors = [h._data for h in heads]
    if any(t.grad_fn is None and not t.requires_grad for t in tensors):
        raise ValueError("cannot differentiate a head that was not "
                         "recorded (did you forget autograd.record()?)")
    if head_grads is None:
        head_grads = [None] * len(tensors)
    # a head without a seed gets ones (MXNet: d(sum of the head))
    seeds = [torch.ones_like(t) if g is None else g._data
             for t, g in zip(tensors, head_grads)]
    leaves = [t for t in tensors if t.grad_fn is None] + _leaves(tensors)
    grads = torch.autograd.grad(tensors, leaves, grad_outputs=seeds,
                                retain_graph=retain_graph,
                                allow_unused=True)
    with torch.no_grad():
        for leaf, g in zip(leaves, grads):
            if g is None:
                continue
            # the leaf's own buffer, written in place: gradients handed
            # out by the graph may alias one another or be broadcast views
            buf = leaf.grad
            if buf is None:
                buf = leaf.grad = torch.zeros_like(
                    leaf, memory_format=torch.contiguous_format)
            if getattr(leaf, "_mx_grad_req", "write") == "add":
                buf.add_(g)
            else:
                buf.copy_(g)
            leaf._mx_fresh_grad = True


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` (NDArrays),
    returned as a list of NDArrays; nothing is written to ``.grad``. A
    gradient that a captured hybridized call hands out in its own buffer
    (``compile.holds``) is returned as a copy."""
    from . import compile as _compile
    from .ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if isinstance(variables, NDArray):
        variables = [variables]
    if isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    seeds = None if head_grads is None else [g._data for g in head_grads]
    out = torch.autograd.grad([h._data for h in heads],
                              [v._data for v in variables],
                              grad_outputs=seeds,
                              retain_graph=retain_graph,
                              create_graph=create_graph)
    return [NDArray(g.clone() if _compile.holds(g) else g) for g in out]


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each NDArray of ``variables`` a leaf whose gradient
    ``backward`` writes into (or, with ``grad_req="add"``, adds to) the
    NDArray of ``gradients`` beside it (MXNet's
    ``MXAutogradMarkVariables``)."""
    from .ndarray import NDArray

    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        var.attach_grad(req)
        if req != "null":
            if g.shape != var.shape or g.dtype != var.dtype:
                raise ValueError(f"mark_variables: a gradient of shape "
                                 f"{g.shape} and {g.dtype} for a variable "
                                 f"of {var.shape} and {var.dtype}")
            var._data.grad = g._data


def get_symbol(x):
    """Raises, as the JAX package does: the tape is PyTorch's and holds
    no Symbol (trace a block with ``export`` instead)."""
    raise NotImplementedError(
        "autograd.get_symbol: the imperative tape does not materialise a "
        "Symbol; use mxnet_tpu_torch.symbol tracing instead")


class _FunctionNode(torch.autograd.Function):
    """The autograd node of one :class:`Function` call."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        from .ndarray import NDArray

        ctx.fn = fn
        with pause():
            outs = fn.forward(*[NDArray(t) for t in tensors])
        fn._single = isinstance(outs, NDArray)   # read back by __call__
        return tuple(o._data for o in ([outs] if fn._single else outs))

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray import NDArray

        with pause():
            got = ctx.fn.backward(*[NDArray(g) for g in grads])
        if isinstance(got, NDArray):
            got = (got,)
        return (None,) + tuple(None if g is None else g._data for g in got)


class Function:
    """A differentiable function written as ``forward`` and ``backward``
    on NDArrays (MXNet's ``mx.autograd.Function``): subclass it, call an
    instance on NDArrays. Under :func:`record`, its outputs hold one
    autograd node whose backward calls ``backward`` with the gradients of
    the outputs and takes the gradients of the inputs it returns (one
    NDArray, or one per input; None for an input without one)."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray

        outs = [NDArray(o) for o in
                _FunctionNode.apply(self, *[x._data for x in inputs])]
        return outs[0] if self._single else outs
