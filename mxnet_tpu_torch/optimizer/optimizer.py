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
the JAX package does (:725), and rounded once to float32. An
``lr_scheduler`` (``mxnet_tpu_torch.lr_scheduler``) gives the base rate
at ``num_update``, with its ``base_lr`` set from ``learning_rate``.

The kernels take float32 only, so each parameter's route is chosen by
its dtype before any launch: float32 weights go to the fused kernel; a
float16 or bfloat16 weight under ``multi_precision`` has a float32
master copy first in its state (``create_state_multi_precision``), which
goes to the fused kernel with the gradient cast to float32, and the
weight is then rewritten as ``master.to(weight.dtype)`` (JAX :80-98);
any other half-precision weight is updated by the plain op in its own
type, with the learning rate and weight decay rounded to that type, as
the JAX package's fused step (:211-219) does. Where the JAX package's
``_fused_common`` (:112-123) drops to a per-parameter loop for
multi-precision, the port batches the masters into the one launch: the
update is elementwise and the kernel bit-exact, so the values are the
loop's.

Not ported yet, and refused with :class:`MXNetError` rather than
accepted: the other 15 optimizers of the JAX package's zoo.
"""
from __future__ import annotations

import math
import pickle

import torch

from .. import kernels as _kernels
from ..base import HALF_DTYPES, MXNetError
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
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
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
        """The state of ``weight``; under ``multi_precision`` a float16 or
        bfloat16 weight's is ``(float32 master copy, the state of the
        master)``."""
        if self.multi_precision and weight._data.dtype in HALF_DTYPES:
            master = NDArray(weight._data.detach().to(torch.float32))
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        """Update one parameter in place (NDArrays)."""
        self.fused_update_multi([index], [weight], [grad], [state])

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update`, through the master copy where ``state`` holds
        one."""
        self.fused_update_multi([index], [weight], [grad], [state])

    def fused_update_multi(self, indices, weights, grads, states):
        """Update many parameters at once, in place."""
        raise NotImplementedError

    def _routes(self, weights, grads, states):
        """The update's operands by route, chosen by dtype: ``fused``, the
        ``(position, weight, grad, state tensors)`` of float32 weights and
        of the masters of half-precision ones (their gradients cast to
        float32), for the kernel; ``plain``, those of the other
        half-precision weights; ``masters``, ``(weight, master)`` pairs to
        write back after the update."""
        fused, plain, masters = [], [], []
        for pos, (w, g, st) in enumerate(zip(weights, grads, states)):
            w, g = w._data, g._data
            if w.dtype in HALF_DTYPES and self.multi_precision:
                master, st = st[0]._data, st[1]
                masters.append((w, master))
                fused.append((pos, master, g.to(torch.float32), _raw(st)))
            elif w.dtype in HALF_DTYPES:
                plain.append((pos, w, g, _raw(st)))
            else:
                fused.append((pos, w, g, _raw(st)))
        return fused, plain, masters

    def _update_routes(self, indices, weights, grads, states, lrs, kernel,
                       plain):
        """Run ``kernel(lr scalar, wds, [(pos, w, g, state)])`` once per
        learning-rate group of the fused route, ``plain(w, g, state, lr,
        wd)`` per tensor of the plain route (lr and wd as 0-dim tensors of
        the weight's type), then copy the masters into their weights."""
        wds = self._get_wds(indices)
        fused, half, masters = self._routes(weights, grads, states)
        if fused:
            device = fused[0][1].device
            for lr, sel in self._lr_groups([lrs[f[0]] for f in fused],
                                           device):
                group = [fused[i] for i in sel]
                kernel(lr, [wds[f[0]] for f in group], group)
        for pos, w, g, st in half:
            plain(w, g, st, torch.full((), lrs[pos], dtype=w.dtype,
                                       device=w.device),
                  torch.full((), wds[pos], dtype=w.dtype, device=w.device))
        if masters:
            torch._foreach_copy_([w for w, _ in masters],
                                 [m for _, m in masters])

    # ------------------------------------------------------------- mults ---
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
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
        return self._mults(indices, self.learning_rate, self.lr_mult,
                           "lr_mult")

    def _get_wds(self, indices):
        return self._mults(indices, self.wd, self.wd_mult, "wd_mult")

    @property
    def learning_rate(self):
        """The base learning rate at ``num_update`` (the scheduler's, when
        there is one), without per-parameter multipliers."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def _clip(self):
        return self.clip_gradient if self.clip_gradient else -1.0

    def _lr_groups(self, lrs, device):
        """``(lr scalar, positions)`` per distinct learning rate, in order
        of first use. The scalar is a float32 0-dim tensor on ``device``,
        refilled for each group (fills and launches are ordered on the
        stream)."""
        groups = {}
        for pos, lr in enumerate(lrs):
            groups.setdefault(float(lr), []).append(pos)
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


def _raw(state):
    """An optimizer state (None, an NDArray or a tuple of them) as a
    tuple of tensors."""
    if state is None:
        return ()
    if isinstance(state, NDArray):
        return (state._data,)
    return tuple(s._data for s in state)


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
        """SGD-momentum through the ``opt_sgd`` family (K1) on the fused
        route, ``sgd_mom_update`` on the plain one; plain SGD, which had
        no TPU kernel, through ``sgd_update``."""
        self._update_count(list(indices))
        hyper = dict(rescale_grad=self.rescale_grad,
                     clip_gradient=self._clip())

        def kernel(lr, wds, group):
            if self.momentum != 0.0:
                _kernels.dispatch(
                    "opt_sgd", [f[1] for f in group], [f[2] for f in group],
                    [f[3][0] for f in group], lr, wds,
                    momentum=self.momentum, **hyper)
                return
            for (_, w, g, _), wd in zip(group, wds):
                plain(w, g, (), lr, wd)

        def plain(w, g, st, lr, wd):
            if self.momentum != 0.0:
                w2, m2 = _ops.sgd_mom_update(w, g, st[0], lr=lr, wd=wd,
                                             momentum=self.momentum, **hyper)
                st[0].copy_(m2)
            else:
                w2 = _ops.sgd_update(w, g, lr=lr, wd=wd, **hyper)
            w.copy_(w2)

        with torch.no_grad():
            self._update_routes(indices, weights, grads, states,
                                self._get_lrs(indices), kernel, plain)


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
        """Adam through the ``opt_adam`` family (K2) on the fused route,
        ``adam_update`` on the plain one."""
        self._update_count(list(indices))
        counts = [self._index_update_count[i] for i in indices]
        lrs = [lr * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
               for lr, t in zip(self._get_lrs(indices), counts)]
        hyper = dict(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                     rescale_grad=self.rescale_grad,
                     clip_gradient=self._clip())

        def kernel(lr, wds, group):
            _kernels.dispatch(
                "opt_adam", [f[1] for f in group], [f[2] for f in group],
                [f[3][0] for f in group], [f[3][1] for f in group], lr, wds,
                **hyper)

        def plain(w, g, st, lr, wd):
            for old, new in zip((w,) + st, _ops.adam_update(
                    w, g, st[0], st[1], lr=lr, wd=wd, **hyper)):
                old.copy_(new)

        with torch.no_grad():
            self._update_routes(indices, weights, grads, states, lrs, kernel,
                                plain)


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

    def update_multi(self, indices, grads, weights):
        """Every key's update at once (one fused launch per learning-rate
        group, the masters of multi-precision weights among them)."""
        states = [self._state(i, w) for i, w in zip(indices, weights)]
        self.optimizer.fused_update_multi(indices, weights, grads, states)

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
