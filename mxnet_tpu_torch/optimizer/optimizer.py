"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``: the ``Optimizer``
base (:28) with ``learning_rate``, ``wd``, ``rescale_grad`` and
``clip_gradient``, per-parameter ``lr_mult`` / ``wd_mult`` (from the
``param_dict`` of Parameters that ``gluon.Trainer`` passes, else the
``set_lr_mult`` / ``set_wd_mult`` tables), the update counts, the
registry (``register`` / ``create``), all 17 optimizers of the JAX zoo
(``SGD`` :288, ``SGLD`` :370, ``Signum`` :389, ``FTML`` :420, ``LARS``
:451, ``LBSGD`` :483, ``LAMB`` :581, ``DCASGD`` :622, ``NAG`` :654,
``Adam`` :685, ``AdaGrad`` :737, ``RMSProp`` :759, ``AdaDelta`` :800,
``Ftrl`` :825, ``Adamax`` :851, ``Nadam`` :878, ``Test`` :917), and the
``Updater`` of update-on-kvstore (:928-979).

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

A row-sparse gradient (``ndarray/sparse.py``) given to SGD takes the
lazy update of its rows (``SGD._sparse_update``, JAX :318-355) and never
reaches K1: ``fused_update_multi``, which ``update``, ``Updater`` and
``Updater.update_multi`` all reach, splits such keys off and keeps the
dense rest on one launch. Every other optimizer reads its dense view, as
the JAX optimizers do (JAX ``Adam.update`` :701-718 ignores
``lazy_update``, so Adam updates every row's moments where MXNet 1.x's
lazy Adam would leave untouched rows alone; ROADMAP.md section C).

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

The other fifteen update one parameter at a time (``update``), as the
JAX package's eager ones do, through the ops of ``ops/optimizer_op.py``
(or, where the JAX optimizer composes NDArray arithmetic, the same
arithmetic in the same order), in place; their ``fused_update_multi``
loops over ``update_multi_precision``, except NAG's, which runs its
momentum step over every float32 tensor of a learning-rate group with
``torch._foreach_*`` (the JAX package jits it over all of them,
``_fused_sgd_like``). Under ``multi_precision`` a half-precision
weight's update runs on its float32 master with the gradient cast to
float32, and the weight is then rewritten from the master (JAX
:91-98). Host state stays on the host as in the JAX optimizers: the
update counts (FTML, LAMB, Adamax and Nadam's bias corrections), Nadam's
``m_schedule`` (one float advanced by every update, the JAX
optimizer's order-dependent form) and LBSGD's accumulated gradients;
the compiled trainer's rules (``parallel/opt_rules.py``) keep them as
device scalars instead. SGLD's noise comes from ``mx.random``'s
generator of the weight's device.
"""
from __future__ import annotations

import math
import pickle

import torch

from .. import kernels as _kernels
from ..base import HALF_DTYPES
from ..ndarray import NDArray
from ..ops import optimizer_op as _ops

__all__ = ["Optimizer", "register", "create", "SGD", "Signum", "SignSGD",
           "FTML", "LARS", "LBSGD", "LAMB", "DCASGD", "NAG", "SGLD", "Adam",
           "AdaGrad", "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam",
           "Test", "Updater", "get_updater"]

# every optimizer the JAX package registers, all of them registered here
_ZOO = ("sgd", "signum", "ftml", "lars", "lbsgd", "lamb", "dcasgd", "nag",
        "sgld", "adam", "adagrad", "rmsprop", "adadelta", "ftrl", "adamax",
        "nadam", "test")


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
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update`, on the float32 master where ``state`` holds one
        (the gradient cast to float32), the weight then rewritten from
        it."""
        if self.multi_precision and weight._data.dtype in HALF_DTYPES:
            master, inner = state
            self.update(index, master, NDArray(grad._data.to(torch.float32)),
                        inner)
            with torch.no_grad():
                weight._data.copy_(master._data)
        else:
            self.update(index, weight, grad, state)

    def fused_update_multi(self, indices, weights, grads, states):
        """Update many parameters at once, in place: one
        :meth:`update_multi_precision` after another, unless the optimizer
        has a multi-tensor step."""
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update_multi_precision(i, w, g, s)

    def _fused_one(self, index, weight, grad, state):
        """``update`` of an optimizer whose step is multi-tensor: the
        step over one parameter, masters included."""
        self.fused_update_multi([index], [weight], [grad], [state])

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

    def _get_lr(self, index):
        return self._get_lrs([index])[0]

    def _get_wd(self, index):
        return self._get_wds([index])[0]

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


def _zeros(weight, dtype=None):
    w = weight._data.detach()
    return NDArray(torch.zeros_like(w, dtype=dtype))


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

    update = update_multi_precision = Optimizer._fused_one

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros(weight)
        return None

    def fused_update_multi(self, indices, weights, grads, states):
        """SGD-momentum through the ``opt_sgd`` family (K1) on the fused
        route, ``sgd_mom_update`` on the plain one; plain SGD, which had
        no TPU kernel, through ``sgd_update``. A row-sparse gradient
        leaves the list before any of them sees it: with ``lazy_update``
        (the default) it takes :meth:`_sparse_update`, else it is
        densified, as the JAX ``SGD.update`` does; the dense rest is still
        one launch per learning-rate group."""
        self._update_count(list(indices))
        rest = self._lazy_rows(indices, weights, grads, states)
        if len(rest) < len(weights):
            if not rest:
                return
            indices, weights, grads, states = (
                [xs[p] for p in rest] for xs in (indices, weights, grads,
                                                 states))
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

    def _lazy_rows(self, indices, weights, grads, states):
        """Apply the lazy update to every row-sparse gradient of the list
        that takes it; return the positions of the others."""
        from ..ndarray.sparse import RowSparseNDArray

        lazy = [p for p, (w, g) in enumerate(zip(weights, grads))
                if isinstance(g, RowSparseNDArray) and self.lazy_update
                and not (self.multi_precision
                         and w._data.dtype in HALF_DTYPES)]
        if not lazy:
            return list(range(len(weights)))
        keys = [indices[p] for p in lazy]
        for p, lr, wd in zip(lazy, self._get_lrs(keys), self._get_wds(keys)):
            self._sparse_update(weights[p], grads[p], states[p], lr, wd)
        skip = set(lazy)
        return [p for p in range(len(weights)) if p not in skip]

    def _sparse_update(self, weight, grad, state, lr, wd):
        """Lazy row-sparse SGD (JAX ``SGD._sparse_update`` :318-355, MXNet
        1.x ``SGDUpdateRowSparse``): only the gradient's rows are read and
        written, weight decay and momentum included. Duplicate rows are
        merged first (``index_add_`` on a card is exact only for unique
        indices); then ``g = clip(rescale_grad * rows) + wd * w[idx]`` and
        ``w[idx] -= lr * g`` without momentum, else ``m_rows = momentum *
        m[idx] - lr * g``, ``w[idx] += m_rows`` and ``m[idx] = m_rows``,
        in the weight's dtype with ``lr`` and ``wd`` rounded to it."""
        from ..ndarray.sparse import merge_duplicates

        grad = merge_duplicates(grad)
        w = weight._data
        idx = grad.indices._data
        with torch.no_grad():
            g = grad.data._data.to(w.dtype) * self.rescale_grad
            if self.clip_gradient and self.clip_gradient > 0:
                g = g.clamp(-self.clip_gradient, self.clip_gradient)
            g = g + wd * w.index_select(0, idx)
            if state is None:
                w.index_add_(0, idx, -lr * g)
                return
            m = state._data
            m_rows = self.momentum * m.index_select(0, idx) - lr * g
            w.index_add_(0, idx, m_rows)
            m.index_copy_(0, idx, m_rows)


@register
class Adam(Optimizer):
    """Adam; the bias correction is folded into the learning rate."""

    update = update_multi_precision = Optimizer._fused_one

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

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


def _hyper(opt):
    return dict(rescale_grad=opt.rescale_grad, clip_gradient=opt._clip())


def _write(pairs):
    """Copy each new tensor into its NDArray's storage."""
    for nd_arr, new in pairs:
        nd_arr._data.copy_(new)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half an SGD step plus
    ``N(0, lr)`` noise from ``mx.random``'s generator."""

    def update(self, index, weight, grad, state):
        from ..ndarray import random as _nd_random

        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        with torch.no_grad():
            g = _ops._prep_grad(grad._data, self.rescale_grad, self._clip())
            noise = _nd_random.normal(0, math.sqrt(lr), shape=w.shape,
                                      dtype=w.dtype, ctx=weight.context)
            w.copy_(w - lr / 2 * (g + wd * w) + noise._data)


@register
class Signum(Optimizer):
    """The sign of the momentum (signSGD without it)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        hyper = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                     **_hyper(self))
        with torch.no_grad():
            if state is not None:
                w, m = _ops.signum_update(
                    weight._data, grad._data, state._data,
                    momentum=self.momentum, wd_lh=self.wd_lh, **hyper)
                _write([(weight, w), (state, m)])
            else:
                _write([(weight, _ops.signsgd_update(
                    weight._data, grad._data, **hyper))])


SignSGD = Signum


@register
class FTML(Optimizer):
    """Follow the moving leader; its state is ``(d, v, z)``."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            outs = _ops.ftml_update(
                weight._data, grad._data, *(s._data for s in state),
                lr=self._get_lr(index), wd=self._get_wd(index),
                beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                rescale_grad=self.rescale_grad, clip_grad=self._clip(),
                t=self._index_update_count[index])
            _write(zip((weight,) + tuple(state), outs))


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling; the norms stay on the device."""

    def __init__(self, momentum=0.0, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        hyper = dict(lr=self._get_lr(index), eta=self.eta,
                     epsilon=self.epsilon, wd=self._get_wd(index),
                     **_hyper(self))
        with torch.no_grad():
            if state is not None:
                w, m = _ops.lars_sgd_mom_update(
                    weight._data, grad._data, state._data,
                    momentum=self.momentum, **hyper)
                _write([(weight, w), (state, m)])
            else:
                _write([(weight, _ops.lars_sgd_update(
                    weight._data, grad._data, **hyper))])


@register
class LBSGD(Optimizer):
    """Large-batch SGD: gradients accumulated over ``batch_scale`` calls
    and a warm-up multiplier of the rate (``linear``, ``power2``,
    ``sqrt``) or a per-layer LARS rate (``lars``)."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.cumgrads = {}

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def _get_lbmult(self, nup):
        """The warm-up multiplier, from 1 to ``batch_scale``."""
        nwup = self.warmup_epochs * self.updates_per_epoch
        maxmult = float(self.batch_scale)
        if nup >= nwup:
            return maxmult
        if nwup <= 1:
            return 1.0
        if self.warmup_strategy == "linear":
            return 1.0 + (maxmult - 1) * nup / nwup
        if self.warmup_strategy == "power2":
            return 1.0 + (maxmult - 1) * (nup * nup) / (nwup * nwup)
        if self.warmup_strategy == "sqrt":
            return 1.0 + (maxmult - 1) * math.sqrt(float(nup) / nwup)
        return 1.0

    @staticmethod
    def _get_lars(weight, g, wd):
        """The layer's LARS multiplier, a device scalar."""
        weight2 = (weight * weight).sum()
        grad2 = (g * g).sum()
        lars = (weight2 / (grad2 + wd * weight2 + 1e-18)) ** 0.5
        return lars.clamp(0.01, 100.0)

    def update(self, index, weight, grad, state):
        # the rate is read before the count moves, as in the JAX optimizer
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        self._update_count(index)
        w = weight._data
        with torch.no_grad():
            cgrad = self.cumgrads.get(index)
            if cgrad and cgrad["num_cums"] > 0:
                cgrad = {"cum_grad": cgrad["cum_grad"] + grad._data,
                         "num_cums": cgrad["num_cums"] + 1}
            else:
                cgrad = {"cum_grad": grad._data.clone(),
                         "num_cums": self.init_updates + 1}
            self.cumgrads[index] = cgrad
            if cgrad["num_cums"] % self.batch_scale != 0:
                return   # inside a macro-batch: the weight waits
            g = cgrad["cum_grad"] / self.batch_scale \
                if self.batch_scale > 1 else cgrad["cum_grad"]
            if self.warmup_strategy == "lars":
                lbmult = self._get_lars(w, g, wd)
                gr = _ops._prep_grad(g, self.rescale_grad, self._clip())
                step = (lr * lbmult) * (gr + wd * w)
                if self.momentum != 0.0 and state is not None:
                    mom = self.momentum * state._data - step
                    _write([(state, mom), (weight, w + mom)])
                else:
                    w.copy_(w - step)
            else:
                hyper = dict(lr=lr * self._get_lbmult(cgrad["num_cums"]),
                             wd=wd, **_hyper(self))
                if self.momentum != 0.0 and state is not None:
                    w2, m2 = _ops.sgd_mom_update(w, g, state._data,
                                                 momentum=self.momentum,
                                                 **hyper)
                    _write([(weight, w2), (state, m2)])
                else:
                    w.copy_(_ops.sgd_update(w, g, **hyper))
            self.cumgrads[index]["cum_grad"] = 0


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments: Adam's direction scaled by the trust
    ratio ``||w|| / ||update||``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mean, var = state
        w = weight._data
        with torch.no_grad():
            g, m2, v2 = _ops.lamb_update_phase1(
                w, grad._data, mean._data, var._data, beta1=self.beta1,
                beta2=self.beta2, epsilon=self.epsilon,
                t=self._index_update_count[index],
                bias_correction=self.bias_correction, wd=wd,
                **_hyper(self))
            _write([(mean, m2), (var, v2)])
            w.copy_(_ops.lamb_update_phase2(
                w, g, _ops._norm(w), _ops._norm(g), lr=lr,
                lower_bound=self.lower_bound or -1.0,
                upper_bound=self.upper_bound or -1.0))


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD; its state is ``(momentum or
    None, the previous weight)``."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = NDArray(weight._data.detach().clone())
        return (None if self.momentum == 0.0 else _zeros(weight), prev)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        mom, previous_weight = state
        w = weight._data
        with torch.no_grad():
            g = _ops._prep_grad(grad._data, self.rescale_grad, self._clip())
            delta = -lr * (g + wd * w + self.lamda * g * g
                           * (w - previous_weight._data))
            if mom is not None:
                mom._data.copy_(self.momentum * mom._data + delta)
                delta = mom._data
            new_w = w + delta
            previous_weight._data.copy_(w)
            w.copy_(new_w)


@register
class NAG(Optimizer):
    """Nesterov momentum SGD. ``fused_update_multi`` runs the momentum
    step over every float32 tensor (and master) of a learning-rate group
    with ``torch._foreach_*`` in ``nag_mom_update``'s order of
    operations; without momentum it is ``sgd_update``."""

    update = update_multi_precision = Optimizer._fused_one

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def fused_update_multi(self, indices, weights, grads, states):
        self._update_count(list(indices))
        hyper = _hyper(self)

        def kernel(lr, wds, group):
            if self.momentum == 0.0:
                for (_, w, g, _), wd in zip(group, wds):
                    plain(w, g, (), lr, wd)
                return
            _nag_foreach([f[1] for f in group], [f[2] for f in group],
                         [f[3][0] for f in group], lr, wds, self.momentum,
                         **hyper)

        def plain(w, g, st, lr, wd):
            if self.momentum != 0.0:
                w2, m2 = _ops.nag_mom_update(w, g, st[0], lr=lr, wd=wd,
                                             momentum=self.momentum, **hyper)
                st[0].copy_(m2)
            else:
                w2 = _ops.sgd_update(w, g, lr=lr, wd=wd, **hyper)
            w.copy_(w2)

        with torch.no_grad():
            self._update_routes(indices, weights, grads, states,
                                self._get_lrs(indices), kernel, plain)


def _nag_foreach(ws, gs, moms, lr, wds, momentum, rescale_grad,
                 clip_gradient):
    """``nag_mom_update`` over lists, in place, one ``_foreach`` op per
    op of the single-tensor form (so each element rounds as there)."""
    g = torch._foreach_mul(gs, rescale_grad)
    if clip_gradient is not None and clip_gradient > 0:
        torch._foreach_clamp_min_(g, -clip_gradient)
        torch._foreach_clamp_max_(g, clip_gradient)
    torch._foreach_add_(g, torch._foreach_mul(ws, list(wds)))
    torch._foreach_mul_(moms, momentum)
    torch._foreach_add_(moms, g)
    step = torch._foreach_mul(moms, momentum)
    torch._foreach_add_(step, g)
    torch._foreach_mul_(step, lr)
    torch._foreach_sub_(ws, step)


@register
class AdaGrad(Optimizer):
    """AdaGrad; ``eps`` is its stability constant."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            w, h = _ops.adagrad_update(
                weight._data, grad._data, state._data,
                lr=self._get_lr(index), wd=self._get_wd(index),
                epsilon=self.float_stable_eps, **_hyper(self))
            _write([(weight, w), (state, h)])


@register
class RMSProp(Optimizer):
    """RMSProp; ``centered=True`` is Graves' form (``rmspropalex``)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return tuple(_zeros(weight) for _ in range(3 if self.centered else 1))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        common = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      gamma1=self.gamma1, epsilon=self.epsilon,
                      clip_weights=self.clip_weights or -1.0, **_hyper(self))
        raw = tuple(s._data for s in state)
        with torch.no_grad():
            if self.centered:
                outs = _ops.rmspropalex_update(weight._data, grad._data,
                                               *raw, gamma2=self.gamma2,
                                               **common)
            else:
                outs = _ops.rmsprop_update(weight._data, grad._data, *raw,
                                           **common)
            _write(zip((weight,) + tuple(state), outs))


@register
class AdaDelta(Optimizer):
    """AdaDelta; no learning rate enters the step."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            outs = _ops.adadelta_update(
                weight._data, grad._data, *(s._data for s in state),
                rho=self.rho, epsilon=self.epsilon, wd=self._get_wd(index),
                **_hyper(self))
            _write(zip((weight,) + tuple(state), outs))


@register
class Ftrl(Optimizer):
    """FTRL-proximal; its state is ``(z, n)``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        with torch.no_grad():
            outs = _ops.ftrl_update(
                weight._data, grad._data, *(s._data for s in state),
                lr=self._get_lr(index), wd=self._get_wd(index),
                lamda1=self.lamda1, beta=self.beta, **_hyper(self))
            _write(zip((weight,) + tuple(state), outs))


@register
class Adamax(Optimizer):
    """Adam with the infinity norm."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        lr /= (1.0 - self.beta1 ** self._index_update_count[index])
        w = weight._data
        with torch.no_grad():
            g = _ops._prep_grad_wd(grad._data, w, self.rescale_grad,
                                   self._clip(), wd)
            m_t, u_t = state
            m_t._data.copy_(self.beta1 * m_t._data + (1.0 - self.beta1) * g)
            u_t._data.copy_(torch.maximum(self.beta2 * u_t._data,
                                          torch.abs(g)))
            w.copy_(w - lr * m_t._data / (u_t._data + 1e-8))


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum and the momentum schedule of Dozat
    (2016); ``m_schedule`` is one host float, advanced by every update."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        w = weight._data
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        with torch.no_grad():
            g = _ops._prep_grad_wd(grad._data, w, self.rescale_grad,
                                   self._clip(), wd)
            m_t, v_t = state
            m_t._data.copy_(self.beta1 * m_t._data + (1.0 - self.beta1) * g)
            v_t._data.copy_(self.beta2 * v_t._data
                            + (1.0 - self.beta2) * g * g)
            grad_prime = g / (1.0 - self.m_schedule)
            m_t_prime = m_t._data / (1.0 - m_schedule_next)
            v_t_prime = v_t._data / (1.0 - self.beta2 ** t)
            m_t_bar = (1.0 - momentum_t) * grad_prime \
                + momentum_t_1 * m_t_prime
            w.copy_(w - lr * m_t_bar / (v_t_prime.sqrt() + self.epsilon))


@register
class Test(Optimizer):
    """``weight -= grad * rescale_grad * lr``, the new weight kept as the
    state: for tests."""

    def create_state(self, index, weight):
        return _zeros(weight, dtype=torch.float32)

    def update(self, index, weight, grad, state):
        w = weight._data
        with torch.no_grad():
            w.copy_(w - grad._data * self.rescale_grad * self.lr)
            state._data.copy_(w)


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
