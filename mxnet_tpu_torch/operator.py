"""``mx.operator``: user-defined operators in Python.

Counterpart of ``mxnet_tpu/operator.py`` (MXNet 1.x
``python/mxnet/operator.py``: ``CustomOp`` :523, ``CustomOpProp`` :674,
``register`` :756). A registered prop drives the ``Custom`` op
(:mod:`mxnet_tpu_torch.ops.custom`), so one definition serves
``mx.nd.Custom`` eagerly and under ``autograd.record()``, hybridized
blocks and Symbol executors (``mx.sym.Custom``). The operator's
``forward`` and ``backward`` get NDArrays on the inputs' device; a body
that reads them on the host (``asnumpy()``) makes its graph run
uncaptured (``ops/custom.py``).

Usage, as in MXNet::

    class Sigmoid(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            y = 1.0 / (1.0 + mx.nd.exp(-in_data[0]))
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    @mx.operator.register("sigmoid")
    class SigmoidProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    out = mx.nd.Custom(x, op_type="sigmoid")
"""
from __future__ import annotations

from .ops.custom import CUSTOM_PROPS

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators"]


class CustomOp:
    """Base class of a custom operator's computation."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Compute ``out_data`` from ``in_data`` (NDArrays)."""
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Compute ``in_grad`` from ``out_grad`` (NDArrays)."""
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as the request says: ``"null"``
        nothing, ``"add"`` adds, ``"write"`` and ``"inplace"``
        overwrite."""
        if req == "null":
            return
        if req == "add":
            dst[:] = dst + src
        else:
            dst[:] = src


class CustomOpProp:
    """A custom operator's signature: its arguments, outputs and
    auxiliary states, shape and type inference, and the operator's
    factory."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = bool(need_top_grad)

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        """By default every output takes the first input's shape."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def infer_storage_type(self, stype_vector):
        return (stype_vector, ["default"] * len(self.list_outputs()),
                ["default"] * len(self.list_auxiliary_states()))

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        """What the backward reads: the output gradients only when
        ``need_top_grad``. Kept for MXNet's API: the autograd node keeps
        the inputs and outputs, and the backward reads what it needs."""
        deps = list(out_grad) if self.need_top_grad_ else []
        return deps + list(in_data) + list(out_data)

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError

    @property
    def need_top_grad(self):
        return self.need_top_grad_


def register(reg_name):
    """Decorator: register a :class:`CustomOpProp` subclass as
    ``op_type=reg_name``."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise TypeError("register() expects a CustomOpProp subclass")
        CUSTOM_PROPS[reg_name] = prop_cls
        return prop_cls

    return deco


def get_all_registered_operators():
    """The names of every registered custom op type."""
    return list(CUSTOM_PROPS)
