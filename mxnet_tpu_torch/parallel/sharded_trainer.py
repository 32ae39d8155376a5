"""ShardedTrainer: forward, loss, backward and the fused optimizer step.

Counterpart of ``mxnet_tpu/parallel/sharded_trainer.py``. The JAX package
compiles the whole step into one sharded XLA executable with donated
buffers; the port runs it eagerly on the mesh's one device:

1. the forward and the loss under ``autograd.record(train_mode=True)``,
   with the trainable parameters swapped for leaf views of themselves
   through ``gluon.parameter.substitute`` (views share storage, so the
   parameters themselves never carry autograd state). The
   ``grad_req="null"`` parameters (aux state: BatchNorm's running
   statistics) are not substituted: the train-mode forward rewrites them
   (``cached_op.update_state``), as the JAX step returns them (:188-200);
2. ``torch.autograd.grad`` for every trainable parameter (attention's
   gradient through the flash backward kernels);
3. the non-finite guard: one fused all-finite check over the loss and
   every gradient writes a device flag;
4. the optimizer rule (``opt_rules.py``): one launch of the fused kernel
   over all trainable parameters, in place, with the learning rate and
   the step count as device scalars and the flag as its skip switch; a
   skipped step also selects the aux state back to its values from
   before the step, on the device (:601-602). Aux state never reaches
   the optimizer.

The host waits for the step only where the JAX package does: reading the
guard's flag to count skipped steps (``nan_guard=True``, the default).

Hyper-parameter handling follows the JAX trainer (:128-183): an optimizer
name plus ``optimizer_params`` (``learning_rate`` popped, the rest to the
optimizer), or an Optimizer instance; weight decay applies to parameters
whose names end in ``weight`` or ``gamma`` (:224-225), so biases and
LayerNorm betas get none.

Not ported yet, and refused with :class:`MXNetError` where the JAX
package would accept them: ``zero``, ``remat``, ``accum_steps > 1``,
``donate=False``, sharding ``rules``, lr schedulers, multi-precision and
bf16 parameters, meshes of more than one device, and the checkpoint,
model-bus, warmup/AOT and telemetry methods.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError
from ..gluon.parameter import substitute
from ..ndarray import NDArray
from .mesh import DeviceMesh
from .opt_rules import RULES

__all__ = ["ShardedTrainer"]


def _not_ported(what):
    return MXNetError(f"ShardedTrainer: {what} is not ported to "
                      "mxnet_tpu_torch yet; see ROADMAP.md section A")


def _unported_method(name, what):
    def method(self, *args, **kwargs):
        raise _not_ported(what)

    method.__name__ = name
    method.__doc__ = f"Not ported yet ({what}); raises MXNetError."
    return method


class ShardedTrainer:
    """Trainer of a HybridBlock on a DeviceMesh of one device.

    Parameters
    ----------
    net : HybridBlock with initialized parameters.
    loss_fn : callable (pred NDArray, label NDArray) -> loss NDArray,
        such as a gluon loss block; the step minimises its mean.
    optimizer : ``"sgd"`` (the default) or ``"adam"``, or an Optimizer
        instance of those.
    mesh : DeviceMesh (default: ``DeviceMesh()``, every card on dp).
    nan_guard : a non-finite loss or gradient skips the whole update
        (parameters and optimizer state stay bit-identical) and counts
        in ``skipped_steps`` / ``consecutive_skips``; after
        ``max_consecutive_skips`` skips in a row ``step`` raises.
    """

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh: Optional[DeviceMesh] = None, rules=None, donate=True,
                 zero=False, remat=False, accum_steps=1, nan_guard=True,
                 max_consecutive_skips=8):
        if int(accum_steps) < 1:
            raise ValueError("accum_steps must be >= 1")
        for on, what in ((zero, "zero (ZeRO-1 sharded optimizer state)"),
                         (remat, "remat (activation recomputation)"),
                         (int(accum_steps) > 1, "accum_steps > 1"),
                         (not donate, "donate=False (the port updates "
                                      "parameters in place)"),
                         (any(rules.values()) if rules else False,
                          "sharding rules")):
            if on:
                raise _not_ported(what)
        self._net = net
        self._loss_fn = loss_fn
        self._mesh = mesh or DeviceMesh()
        self._device = self._mesh.device
        self._nan_guard = bool(nan_guard)
        self._max_consecutive_skips = int(max_consecutive_skips)
        self.skipped_steps = 0       # total updates skipped by the guard
        self.consecutive_skips = 0   # current skip streak

        opt_params = dict(optimizer_params or {})
        if opt_params.pop("lr_scheduler", None) is not None:
            raise _not_ported("lr_scheduler")
        self._lr = float(opt_params.pop("learning_rate", 0.01))
        from .. import optimizer as _opt_mod

        if isinstance(optimizer, _opt_mod.Optimizer):
            self._opt = optimizer
            if opt_params:
                raise ValueError(
                    "optimizer_params other than learning_rate/"
                    "lr_scheduler cannot be combined with an Optimizer "
                    f"instance: {sorted(opt_params)}")
            if "learning_rate" not in (optimizer_params or {}):
                self._lr = float(self._opt.lr)
        else:
            try:
                self._opt = _opt_mod.create(
                    optimizer, learning_rate=self._lr, **opt_params)
            except TypeError as e:
                raise ValueError(
                    f"unsupported optimizer params for {optimizer!r}: "
                    f"{e}") from None
        self._opt_name = type(self._opt).__name__.lower()
        if self._opt_name not in RULES:
            raise ValueError(
                f"no update rule for optimizer {self._opt_name!r}; "
                f"available: {sorted(RULES)}")
        self._rule = RULES[self._opt_name]
        self._wd = float(self._opt.wd)

        self._param_names: List[str] = []
        self._params = []
        self._train_handles: List[NDArray] = []
        self._aux_names: List[str] = []
        self._aux_handles: List[NDArray] = []
        for name, p in net.collect_params().items():
            if p._data is None:
                raise ValueError(
                    f"Parameter {name!r} not initialized; run one forward "
                    "pass (or initialize with explicit shapes) first")
            if p.grad_req == "null":
                self._aux_names.append(name)
                self._aux_handles.append(p.data())
                continue
            if p.dtype != torch.float32:
                raise _not_ported(f"training {p.dtype} parameters "
                                  f"({name!r}; multi-precision)")
            self._param_names.append(name)
            self._params.append(p)
            self._train_handles.append(p.data())
        self._wd_mult = [1.0 if (n.endswith("weight") or n.endswith("gamma"))
                         else 0.0 for n in self._param_names]
        self._place_params()
        self._opt_state = [self._rule.init(self._opt, h._data)
                           for h in self._train_handles]
        self._t = 0
        self._t_dev = torch.zeros((), dtype=torch.float32, device=self._device)
        self._lr_dev = torch.zeros((), dtype=torch.float32,
                                   device=self._device)
        self._one = torch.ones((), dtype=torch.float32, device=self._device)

    def _place_params(self):
        """Every parameter on the mesh's device, contiguous (the fused
        kernels update the trainable ones in place)."""
        for h in self._train_handles + self._aux_handles:
            if h._data.device != self._device or \
                    not h._data.is_contiguous():
                h._rebind(h._data.detach().to(self._device).contiguous())

    @property
    def learning_rate(self):
        """The lr of the next step; settable between steps (the step
        reads it from a device scalar, so nothing is rebuilt)."""
        return self._lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self._lr = float(lr)

    def _put_batch(self, x):
        raw = x._data if isinstance(x, NDArray) else \
            torch.from_numpy(_np.ascontiguousarray(x))
        return raw.to(self._device)

    # -------------------------------------------------------------- step ---
    def step(self, x, y):
        """One training step on batch ``(x, y)``; returns the loss (the
        mean of ``loss_fn`` over the batch) as an NDArray.

        With ``nan_guard`` a step whose loss or gradients are not finite
        leaves parameters and optimizer state untouched (the step
        counter still advances); ``max_consecutive_skips`` such steps in
        a row raise RuntimeError."""
        x_raw, y_raw = self._put_batch(x), self._put_batch(y)
        self._t += 1
        self._t_dev.fill_(float(self._t))
        self._lr_dev.fill_(self._lr)
        weights = [h._data for h in self._train_handles]
        aux_before = [h._data for h in self._aux_handles]
        leaves = [w.detach().requires_grad_(True) for w in weights]
        with substitute({p: NDArray(leaf)
                         for p, leaf in zip(self._params, leaves)}), \
                autograd.record(train_mode=True):
            out = self._net.forward(NDArray(x_raw))
            loss = self._loss_fn(out, NDArray(y_raw)).mean()._data
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(weights, grads)]
        loss = loss.detach()
        skip = None
        if self._nan_guard:
            skip = torch.zeros(1, dtype=torch.float32, device=self._device)
            # scales by 1.0 (exact) and sets skip when any value is not
            # finite: one fused pass over the loss and every gradient
            torch._amp_foreach_non_finite_check_and_unscale_(
                [loss.reshape(1)] + grads, skip, self._one)
        wds = [self._wd * m for m in self._wd_mult]
        with torch.no_grad():
            self._rule.update(self._opt, weights, grads, self._opt_state,
                              self._lr_dev, wds, self._t_dev, skip)
            if skip is not None:
                for h, old in zip(self._aux_handles, aux_before):
                    if h._data is not old:
                        h._rebind(torch.where(skip != 0, old, h._data))
        if self._nan_guard:
            self._account_skip(not bool(skip.item()))  # waits for the step
        return NDArray(loss)

    def _account_skip(self, ok):
        if ok:
            self.consecutive_skips = 0
            return
        self.skipped_steps += 1
        self.consecutive_skips += 1
        if self.consecutive_skips >= self._max_consecutive_skips:
            raise RuntimeError(
                f"ShardedTrainer: {self.consecutive_skips} consecutive "
                "steps produced non-finite loss/gradients and were "
                f"skipped (step {self._t}, {self.skipped_steps} skipped "
                "total): the run has diverged; lower the learning rate or "
                "check the data pipeline")

    def predict(self, x):
        """Inference forward (train mode off, nothing recorded)."""
        with autograd.pause(train_mode=False):
            out = self._net.forward(NDArray(self._put_batch(x)))
        return NDArray(out._data)

    warmup = _unported_method("warmup", "warmup (AOT compile)")
    aot_lower = _unported_method("aot_lower", "aot_lower")
    step_report = _unported_method("step_report", "step telemetry")
    publish_to = _unported_method("publish_to", "the model bus")
    publish_update = _unported_method("publish_update", "the model bus")
    save_states = _unported_method("save_states", "checkpoints")
    load_states = _unported_method("load_states", "checkpoints")
    save_checkpoint = _unported_method("save_checkpoint", "checkpoints")
    resume = _unported_method("resume", "checkpoints")
    topology_meta = _unported_method("topology_meta", "checkpoints")
    unshard = _unported_method("unshard", "unshard")
