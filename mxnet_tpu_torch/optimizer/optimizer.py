"""Optimizers: hyper-parameters and state for the fused training step.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``: the ``Optimizer``
base (:28) with ``learning_rate``, ``wd``, ``rescale_grad`` and
``clip_gradient``, its registry (``register`` / ``create``), ``SGD``
(:288) and ``Adam`` (:685). In the port an optimizer is the static source
of hyper-parameters for :class:`mxnet_tpu_torch.parallel.ShardedTrainer`,
whose update runs through the fused kernels (``parallel/opt_rules.py``).

Not ported yet, and refused with :class:`MXNetError` rather than
accepted: the eager per-parameter ``update`` (what ``gluon.Trainer``
calls), lr schedulers, multi-precision (bf16 weights with float32 master
copies) and the other 15 optimizers of the JAX package's zoo.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["Optimizer", "register", "create", "SGD", "Adam"]

# every optimizer the JAX package registers; those not registered here
# are not ported yet
_ZOO = ("sgd", "signum", "ftml", "lars", "lbsgd", "lamb", "dcasgd", "nag",
        "sgld", "adam", "adagrad", "rmsprop", "adadelta", "ftrl", "adamax",
        "nadam", "test")


def _not_ported(what):
    return MXNetError(f"{what} is not ported to mxnet_tpu_torch yet; see "
                      "ROADMAP.md section A")


class Optimizer:
    """Base optimizer: learning rate, weight decay, gradient rescale and
    clip (``None`` or a value <= 0 means no clip)."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None, aggregate_num=0):
        if lr_scheduler is not None:
            raise _not_ported("lr_scheduler")
        if multi_precision:
            raise _not_ported("multi_precision")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        key = name.lower()
        if key in Optimizer.opt_registry:
            return Optimizer.opt_registry[key](**kwargs)
        if key in _ZOO:
            raise _not_ported(f"optimizer {name!r}")
        raise ValueError(f"Cannot find optimizer {name}; registered: "
                         f"{sorted(Optimizer.opt_registry)}")

    def update(self, index, weight, grad, state):
        raise _not_ported("the eager Optimizer.update (gluon.Trainer)")

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr}, wd={self.wd})"


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` is non-zero."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update


@register
class Adam(Optimizer):
    """Adam; the bias correction is folded into the learning rate."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update
