"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``: the ``Optimizer``
base (:28) with ``learning_rate``, ``wd``, ``rescale_grad`` and
``clip_gradient``, per-parameter ``lr_mult`` / ``wd_mult`` (from the
``param_dict`` of Parameters that ``gluon.Trainer`` passes, else the
``set_lr_mult`` / ``set_wd_mult`` tables), the update counts, the
registry (``register`` / ``create``), ``SGD`` (:288) and ``Adam``
(:685), and the ``Updater`` of update-on-kvstore (:928-979).

An optimizer is the source of hyper-parameters for
:class:`mxnet_tpu_torch.parallel.ShardedTrainer` and updates weights
itself for ``gluon.Trainer`` and the kvstore:

* ``fused_update_multi(indices, weights, grads, states)`` updates many
  parameters at once, in place: on the card SGD with momentum and Adam
  launch the fused kernels (K1 ``opt_sgd``, K2 ``opt_adam``) once over
  every parameter that shares a learning rate (one launch when no
  ``lr_mult`` differs), on the CPU their plain versions
  (``ops/optimizer_op.py``);
* ``update(index, weight, grad, state)`` is the same for one parameter.

The learning rate reaches the kernels as a float32 device scalar; Adam's
bias correction is folded into it on the host in double precision, as
the JAX package does (:725), and rounded once to float32.

Not ported yet, and refused with :class:`MXNetError` rather than
accepted: lr schedulers, multi-precision (bf16 weights with float32
master copies) and the other 15 optimizers of the JAX package's zoo.
"""
from __future__ import annotations

import math
import pickle

import torch

from .. import kernels as _kernels
from ..base import MXNetError
from ..ndarray import NDArray
from ..ops import optimizer_op as _ops

__all__ = ["Optimizer", "register", "create", "SGD", "Adam", "Updater",
           "get_updater"]

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
        self.lr_scheduler = None
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = False
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        if not isinstance(param_idx2name, (dict, type(None))):
            raise ValueError("param_idx2name should be a dict of param "
                             "indexes to names")
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict if param_dict else {}
        self._lr_scalars = {}   # device -> float32 scalar the kernels read
        self.set_lr_mult({})
        self.set_wd_mult({})

    # ----------------------------------------------------------- registry --
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

    # -------------------------------------------------------------- state --
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        """The state of ``weight`` (multi-precision master copies are not
        ported, so this is :meth:`create_state`)."""
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        """Update one parameter in place (NDArrays)."""
        self.fused_update_multi([index], [weight], [grad], [state])

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    def fused_update_multi(self, indices, weights, grads, states):
        """Update many parameters at once, in place."""
        raise NotImplementedError

    # ------------------------------------------------------------- mults ---
    def set_learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Only ``*_weight`` and ``*_gamma`` of ``idx2name`` get weight
        decay by default."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight") or n.endswith("_gamma"))}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        for idx in index if isinstance(index, (list, tuple)) else [index]:
            count = self._index_update_count.get(idx, self.begin_num_update)
            self._index_update_count[idx] = count + 1
            self.num_update = max(count + 1, self.num_update)

    def _mults(self, indices, base, table, attr):
        out = [base] * len(indices)
        for i, index in enumerate(indices):
            if index in self.param_dict:
                out[i] *= getattr(self.param_dict[index], attr)
            elif index in table:
                out[i] *= table[index]
            elif index in self.idx2name:
                out[i] *= table.get(self.idx2name[index], 1.0)
        return out

    def _get_lrs(self, indices):
        return self._mults(indices, self.lr, self.lr_mult, "lr_mult")

    def _get_wds(self, indices):
        return self._mults(indices, self.wd, self.wd_mult, "wd_mult")

    @property
    def learning_rate(self):
        return self.lr

    def _clip(self):
        return self.clip_gradient if self.clip_gradient else -1.0

    def _lr_groups(self, lrs, weights):
        """``(lr scalar, positions)`` per distinct learning rate, in order
        of first use. The scalar is a float32 0-dim tensor on the weights'
        device, refilled for each group (fills and launches are ordered
        on the stream)."""
        groups = {}
        for pos, lr in enumerate(lrs):
            groups.setdefault(float(lr), []).append(pos)
        device = weights[0]._data.device
        scalar = self._lr_scalars.get(device)
        if scalar is None:
            scalar = self._lr_scalars[device] = torch.zeros(
                (), dtype=torch.float32, device=device)
        for lr, positions in groups.items():
            scalar.fill_(lr)
            yield scalar, positions

    def __getstate__(self):
        state = self.__dict__.copy()
        # neither live Parameters nor device scalars are saved
        state.pop("param_dict", None)
        state.pop("_lr_scalars", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("param_dict", {})
        self.__dict__.setdefault("_lr_scalars", {})

    def __repr__(self):
        return f"{type(self).__name__}(lr={self.lr}, wd={self.wd})"


register = Optimizer.register
create = Optimizer.create_optimizer


def _raws(arrays, positions):
    return [arrays[p]._data for p in positions]


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` is non-zero."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return NDArray(torch.zeros_like(weight._data.detach()))
        return None

    def fused_update_multi(self, indices, weights, grads, states):
        """SGD-momentum through the ``opt_sgd`` family (K1); plain SGD,
        which had no TPU kernel, through ``sgd_update``."""
        self._update_count(list(indices))
        wds = self._get_wds(indices)
        for lr, pos in self._lr_groups(self._get_lrs(indices), weights):
            if self.momentum != 0.0:
                _kernels.dispatch(
                    "opt_sgd", _raws(weights, pos), _raws(grads, pos),
                    _raws(states, pos), lr, [wds[p] for p in pos],
                    momentum=self.momentum, rescale_grad=self.rescale_grad,
                    clip_gradient=self._clip())
                continue
            with torch.no_grad():
                for p in pos:
                    w = weights[p]._data
                    w.copy_(_ops.sgd_update(
                        w, grads[p]._data, lr=lr, wd=wds[p],
                        rescale_grad=self.rescale_grad,
                        clip_gradient=self._clip()))


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

    def create_state(self, index, weight):
        w = weight._data.detach()
        return (NDArray(torch.zeros_like(w)), NDArray(torch.zeros_like(w)))

    def fused_update_multi(self, indices, weights, grads, states):
        """Adam through the ``opt_adam`` family (K2)."""
        self._update_count(list(indices))
        counts = [self._index_update_count[i] for i in indices]
        lrs = [lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
               for lr, t in zip(self._get_lrs(indices), counts)]
        wds = self._get_wds(indices)
        for lr, pos in self._lr_groups(lrs, weights):
            _kernels.dispatch(
                "opt_adam", _raws(weights, pos), _raws(grads, pos),
                [states[p][0]._data for p in pos],
                [states[p][1]._data for p in pos], lr,
                [wds[p] for p in pos], beta1=self.beta1, beta2=self.beta2,
                epsilon=self.epsilon, rescale_grad=self.rescale_grad,
                clip_gradient=self._clip())


class Updater:
    """An Optimizer applied by key, for update-on-kvstore."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def _state(self, index, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self._state(index, weight))

    def get_states(self, dump_optimizer=False):
        if dump_optimizer:
            return pickle.dumps((self.states, self.optimizer))
        return pickle.dumps(self.states)

    def set_states(self, states):
        loaded = pickle.loads(states)
        if isinstance(loaded, tuple) and len(loaded) == 2 and \
                not isinstance(loaded[0], int):
            states, self.optimizer = loaded
        else:
            states = loaded
        self.states = states


def get_updater(optimizer):
    return Updater(optimizer)
