"""ShardedTrainer: forward, loss, backward and the fused optimizer step.

Counterpart of ``mxnet_tpu/parallel/sharded_trainer.py``. The JAX package
compiles the whole step into one sharded XLA executable with donated
buffers (site ``trainer``, :550-628); the port captures it, on the mesh's
one device, into one CUDA graph per batch signature
(``compile.jit``, site ``"trainer"``): the first step of a
signature runs eagerly and is then captured, every later one copies the
batch in and replays. On the CPU the step is a plain call with the same
keys. The step:

1. the forward and the loss under ``autograd.record(train_mode=True)``,
   with the trainable parameters swapped for leaf views of themselves
   through ``gluon.parameter.substitute`` (views share storage, so the
   parameters themselves never carry autograd state). The
   ``grad_req="null"`` parameters (aux state: BatchNorm's running
   statistics) are not substituted: the train-mode forward writes them
   in place (``cached_op.update_state``), as the JAX step returns them
   (:188-200);
2. ``torch.autograd.grad`` for every trainable parameter (attention's
   gradient through the flash backward kernels);
3. the non-finite guard: one fused all-finite check over the loss and
   every gradient writes a device flag;
4. the optimizer rule (``opt_rules.apply``), in place, with the learning
   rate and the step count as device scalars and the flag as its skip
   switch: one launch of the fused kernel over every float32 weight and
   every float32 master copy, and the plain op for half-precision
   weights without ``multi_precision`` (the routes, chosen by dtype,
   are counted in ``route_counts``); a skipped step also selects the aux
   state back to its values from before the step, on the device
   (:601-602), from copies taken before the forward. Aux state never
   reaches the optimizer. The fused kernel reads the gradients where
   autograd left them (in the graph's pool, under capture); its
   parameter-set table over them is filled when the capture ends.

The step's reads (an entry is built anew when one is rebound) are the
weights, the aux state, every optimizer state tensor (the masters
among them) and the masters' gradient buffers. The learning rate, the
step count and the scheduler stay outside the graph: ``_lr_dev`` and
``_t_dev`` are filled before each replay. ``load_states`` and ``resume`` drop the
entries; ``Block.cast`` and ``set_data`` rebind reads, so the next step
captures anew. ``predict`` is a captured forward under the same site
(token ``predict``, JAX :826-836). ``compile.set_enabled(False)`` runs
the same step eagerly.

The host waits for the step only where the JAX package does: reading the
guard's flag, after the replay, to count skipped steps
(``nan_guard=True``, the default).

Hyper-parameter handling follows the JAX trainer (:128-183): an optimizer
name plus ``optimizer_params`` (``learning_rate`` and ``lr_scheduler``
popped, the rest to the optimizer, ``multi_precision`` included), or an
Optimizer instance, whose scheduler is adopted; the scheduler's
``base_lr`` is set from the learning rate. Weight decay applies to
parameters whose names end in ``weight`` or ``gamma`` (:224-225), so
biases and LayerNorm betas get none.

Checkpoints (:922-1237): ``save_states`` / ``load_states`` write and read
the ``nd.save`` container with the JAX package's keys (``__t__``,
``__rng_seed__``, ``__rng_key__``, ``__names__``, ``__sched__``, ``p{i}``,
``a{i}``, ``s{i}_{j}``, positional in ``collect_params`` order) in host
layout, so a JAX checkpoint from any mesh loads here. ``__rng_key__`` holds
the port's own generator state; a JAX file's threefry key restores the
seed alone (``random.set_state``). ``__sched__`` is a pickled scheduler,
read through ``lr_scheduler.loads`` (a JAX pickle names
``mxnet_tpu.lr_scheduler`` classes, which read as the port's). A JAX
trainer loads the port's files too, without a scheduler: with one, its
unpickler would import this package. ``save_checkpoint`` / ``resume``
go through a ``checkpoint.CheckpointManager``.

``remat=True`` runs each step's forward and loss under
``torch.utils.checkpoint`` (recomputed in the backward, Dropout masks
included), and ``accum_steps = k`` accumulates ``k`` microbatches'
gradients inside the one step (:meth:`_step_body`); both are part of
the step's entry key, as in the JAX trainer's (:386).

The JAX trainer's options on a mesh of one device (meshes of more
devices raise in :class:`DeviceMesh`):

* ``rules`` merge over :func:`sharding_rules` (:31-47, :201-203). A rule
  naming an axis the mesh lacks, one axis twice, or more dimensions than
  its array raises ``ValueError`` naming the parameter (the JAX package
  checks this in ``analysis.distcheck``, which is not ported: the check
  lives here); a rule naming no parameter warns. On one device every
  valid rule places its parameter whole; ``topology_meta()`` records the
  rules as given.
* ``zero=True``: ZeRO-1 over a ``dp`` axis of size 1 is the plain
  layout, so the step is the ``zero=False`` step bit for bit;
  ``topology_meta()["zero"]`` records it, and checkpoints of either
  setting load into the other (host layout).
* ``donate=False``: a tensor taken from a parameter's or an optimizer
  state's ``_data`` before a step keeps its values after it. The
  captured step updates a private working set in place (its graph's
  reads keep their addresses); after each step every handle and
  optimizer-state slot gets a fresh device copy of it, and before a step
  a handed-out tensor that was rebound or written in place since is
  copied back in. It costs one device copy of every parameter and state a
  step and twice their memory. ``donate=True`` (the default) updates the
  handles' tensors in place.
* :meth:`warmup` captures the step for a batch signature without taking
  a step; :meth:`aot_lower` traces the step on fake tensors and runs
  nothing; :meth:`step_report` is the step timeline's last record
  (:mod:`~mxnet_tpu_torch.telemetry.steps`: ``h2d`` the batch's
  placement, ``compute`` the replay or the eager call, ``sync`` the
  nan-guard's read; ``flops`` counted when the step's entry was made,
  and ``mfu_xla``); :meth:`unshard` copies the weights to one context;
  ``resume(reshard=)`` compares the checkpoint's topology with this
  trainer's (:1070-1140).

Not ported: the JAX trainer's checkpoint-on-drain hooks
(``_remember_manager``, ``_final_checkpoint``, :1002-1037), which need
``preempt.py``, and the HLO collective census of ``aot_lower``'s result
(``analysis.distcheck``); both wait for ROADMAP.md item A11.

``publish_to`` / ``publish_update`` stream the weights into a model bus
(:mod:`mxnet_tpu_torch.modelbus`) every K steps, in the JAX package's
record format.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import time
import warnings
from typing import Dict, List, Optional

import numpy as _np
import torch

from .. import autograd
from .. import compile as _compile
from .. import faults as _faults
from .. import lr_scheduler as _sched
from .. import random as _random
from ..base import MXNetError
from ..context import cpu
from ..gluon.parameter import substitute
from ..ndarray import NDArray
from ..ndarray import utils as _nd_utils
from ..telemetry import steps as _tsteps
from . import opt_rules
from .mesh import DeviceMesh
from .opt_rules import RULES

__all__ = ["ShardedTrainer", "sharding_rules"]

_ALIGN = 4   # float32 elements in 16 bytes


def sharding_rules(params, mesh: DeviceMesh) -> Dict[str, tuple]:
    """Default per-parameter PartitionSpecs (``mxnet_tpu/parallel/
    sharded_trainer.py:31``): everything replicated except, on a mesh
    whose tp axis is larger than 1, matmul and convolution weights whose
    output dimension divides it, split on that dimension."""
    tp = mesh.size("tp")
    rules: Dict[str, tuple] = {}
    for name, p in params.items():
        shape = p.shape
        spec: tuple = ()
        if tp > 1 and shape and len(shape) >= 2 and shape[0] % tp == 0 \
                and name.endswith("weight"):
            spec = ("tp",) + (None,) * (len(shape) - 1)
        rules[name] = spec
    return rules


def _check_rules(rules, shapes, mesh):
    """The JAX package's sharding check (``analysis.distcheck.
    check_sharding``, its errors and its dead-rule warning) over ``rules``
    ({name: spec}) against ``mesh``: a ``ValueError`` naming the
    parameter."""
    from ..base import did_you_mean

    axes = tuple(mesh.axis_names)
    for name, spec in rules.items():
        spec = tuple(spec or ())
        shape = shapes.get(name)
        if shape is None:
            warnings.warn(f"ShardedTrainer: sharding rule {name!r} names no "
                          f"known parameter{did_you_mean(name, shapes)}; "
                          "the rule is dead", stacklevel=3)
        seen = set()
        for ax in spec:
            for ax_name in (ax if isinstance(ax, (tuple, list)) else (ax,)):
                if ax_name is None:
                    continue
                if ax_name not in axes:
                    raise ValueError(
                        f"ShardedTrainer: sharding rule of parameter "
                        f"{name!r}: PartitionSpec {spec} on {mesh!r}: "
                        f"{mesh.axis_error(ax_name)}")
                if ax_name in seen:
                    raise ValueError(
                        f"ShardedTrainer: sharding rule of parameter "
                        f"{name!r}: PartitionSpec {spec} uses mesh axis "
                        f"{ax_name!r} for more than one dimension")
                seen.add(ax_name)
        if shape is not None and len(spec) > len(shape):
            raise ValueError(
                f"ShardedTrainer: sharding rule of parameter {name!r}: "
                f"PartitionSpec {spec} has {len(spec)} entries for an "
                f"array of shape {tuple(shape)}")


def _batch_spec(x, device):
    """``(shape, torch dtype)`` of a batch given as an NDArray, a tensor,
    a numpy array or a ``(shape, dtype)`` pair (the port's
    ``jax.ShapeDtypeStruct``)."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if isinstance(x, _np.ndarray):
        return tuple(x.shape), torch.from_numpy(x[:0]).dtype
    shape, dtype = x
    from ..base import canonical_dtype

    return tuple(int(d) for d in shape), canonical_dtype(dtype)


class Lowered:
    """What :meth:`ShardedTrainer.aot_lower` returns (the port's reading
    of ``jax.stages.Lowered``): the step traced on fake tensors.

    ``ops`` lists, in dispatch order, each aten op the step dispatched
    and each hand-written kernel family it reached (``kernel <family>``:
    the family's own aten ops are not listed); ``flops`` and ``int_ops``
    are the step's counts (as ``telemetry.costs`` counts them when the
    step's entry is made)."""

    def __init__(self, trainer, x_spec, y_spec, ops, count):
        self._trainer = trainer
        self.x_spec, self.y_spec = x_spec, y_spec
        self.ops = ops
        self.flops, self.int_ops = count.flops, count.int_ops
        self.kernels = dict(count.kernels)

    def as_text(self):
        """The traced step as text: a header with the batch signature,
        then one line per dispatched op."""
        head = (f"# ShardedTrainer step on {self._trainer._device}: "
                f"x {self.x_spec[0]} {self.x_spec[1]}, y {self.y_spec[0]} "
                f"{self.y_spec[1]}; {len(self.ops)} ops, flops "
                f"{self.flops}, kernels {self.kernels}")
        return "\n".join([head] + self.ops) + "\n"

    def compile(self):
        """Capture the step for this signature (:meth:`ShardedTrainer.
        warmup` on zero batches of these shapes); returns its report."""
        dev = self._trainer._device
        return self._trainer.warmup(
            torch.zeros(self.x_spec[0], dtype=self.x_spec[1], device=dev),
            torch.zeros(self.y_spec[0], dtype=self.y_spec[1], device=dev))


def _recorder_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Recorder(TorchDispatchMode):
        """Lists each aten op dispatched (but those of a kernel family's
        plain version or shape inference: ``paused``) and each kernel
        family reached (``on_kernel``)."""

        def __init__(self):
            super().__init__()
            self.ops = []
            self.paused = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not self.paused:
                self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

        def on_kernel(self, family, flops, kind):
            self.ops.append(f"kernel {family}")

    return _Recorder


class _RecomputeScopes:
    """``torch.utils.checkpoint``'s ``context_fn`` for a trainer's
    forward: the first scope notes this thread's port state when the
    forward starts, the second puts it back for the recomputation, which
    on a card runs on autograd's engine thread. That state is the
    recording and training flags, the parameters' leaf views
    (``gluon.parameter.substitute``), the current context, the nesting
    that runs hybridized blocks plainly inside a captured step, and
    ``mx.random``'s generator (:func:`random.snapshot`), so a Dropout
    draws the same mask twice; and BatchNorm's statistics are not
    written twice (``autograd.set_recomputing``)."""

    def __init__(self, device):
        self._device = device
        self._state = None

    @contextlib.contextmanager
    def forward(self):
        from ..context import Context
        from ..gluon import parameter

        self._state = (autograd.is_recording(), autograd.is_training(),
                       getattr(parameter._tls, "subs", None),
                       list(getattr(Context._tls, "stack", None) or []),
                       _random.snapshot(self._device))
        yield

    @contextlib.contextmanager
    def again(self):
        from ..context import Context
        from ..gluon import parameter

        recording, training, subs, stack, snap = self._state
        prev = (autograd.set_recording(recording),
                autograd.set_training(training),
                autograd.set_recomputing(True),
                getattr(parameter._tls, "subs", None),
                getattr(Context._tls, "stack", None))
        parameter._tls.subs = subs
        Context._tls.stack = stack
        try:
            with _compile.nested(), snap.again():
                yield
        finally:
            autograd.set_recording(prev[0])
            autograd.set_training(prev[1])
            autograd.set_recomputing(prev[2])
            parameter._tls.subs = prev[3]
            Context._tls.stack = prev[4]


def _recomputed(run, x_raw, y_raw):
    """``run(x_raw, y_raw)`` whose activations are not kept: recomputed
    in the backward (``use_reentrant=False``, so it captures into a CUDA
    graph; torch's own generator states are not stashed, as the port
    draws from ``mx.random``'s)."""
    from torch.utils.checkpoint import checkpoint

    scopes = _RecomputeScopes(x_raw.device)
    return checkpoint(run, x_raw, y_raw, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (scopes.forward(), scopes.again()))


def _bytes_array(blob):
    return NDArray(torch.from_numpy(_np.frombuffer(blob, _np.uint8).copy()))


class ShardedTrainer:
    """Trainer of a HybridBlock on a DeviceMesh of one device.

    Parameters
    ----------
    net : HybridBlock with initialized parameters (float32, float16 or
        bfloat16; ``Block.cast`` keeps BatchNorm's in float32).
    loss_fn : callable (pred NDArray, label NDArray) -> loss NDArray,
        such as a gluon loss block; the step minimises its mean.
    optimizer : the name of any of the 17 optimizers (``"sgd"``, the
        default, ``"adam"``, ``"lamb"``, ``"rmsprop"``, ...), or an
        Optimizer instance of one.
    optimizer_params : ``learning_rate``, ``lr_scheduler``,
        ``multi_precision`` (float32 master copies of half-precision
        weights) and the optimizer's own.
    mesh : DeviceMesh (default: ``DeviceMesh()``, every card on dp).
    remat : recompute the forward (and the loss) in the backward instead
        of keeping its activations (``torch.utils.checkpoint``, Dropout
        masks drawn again as they were).
    accum_steps : split each batch into this many microbatches whose
        gradients are summed inside the step; the batch must divide.
    nan_guard : a non-finite loss or gradient skips the whole update
        (parameters and optimizer state stay bit-identical) and counts
        in ``skipped_steps`` / ``consecutive_skips``; after
        ``max_consecutive_skips`` skips in a row ``step`` raises.
    rules : ``{param_name: PartitionSpec tuple}`` over
        :func:`sharding_rules`' defaults (checked against the mesh).
    donate : False hands every parameter and optimizer-state slot a fresh
        tensor after each step, leaving the earlier ones as they were
        (the module's docstring).
    zero : ZeRO-1; on a dp axis of size 1 the plain layout.
    """

    def __init__(self, net, loss_fn, optimizer="sgd", optimizer_params=None,
                 mesh: Optional[DeviceMesh] = None, rules=None, donate=True,
                 zero=False, remat=False, accum_steps=1, nan_guard=True,
                 max_consecutive_skips=8):
        if int(accum_steps) < 1:
            raise ValueError("accum_steps must be >= 1")
        self._net = net
        self._loss_fn = loss_fn
        self._remat = bool(remat)
        self._accum = int(accum_steps)
        self._mesh = mesh or DeviceMesh()
        self._device = self._mesh.device
        self._donate = bool(donate)
        self._zero = bool(zero)
        self._nan_guard = bool(nan_guard)
        self._max_consecutive_skips = int(max_consecutive_skips)
        self.skipped_steps = 0       # total updates skipped by the guard
        self.consecutive_skips = 0   # current skip streak

        opt_params = dict(optimizer_params or {})
        self._lr_scheduler = opt_params.pop("lr_scheduler", None)
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
            if self._lr_scheduler is None:
                self._lr_scheduler = self._opt.lr_scheduler
        else:
            try:
                self._opt = _opt_mod.create(
                    optimizer, learning_rate=self._lr, **opt_params)
            except TypeError as e:
                raise ValueError(
                    f"unsupported optimizer params for {optimizer!r}: "
                    f"{e}") from None
        if self._lr_scheduler is not None:
            self._lr_scheduler.base_lr = self._lr
        self._opt_name = type(self._opt).__name__.lower()
        if self._opt_name not in RULES:
            raise ValueError(
                f"no update rule for optimizer {self._opt_name!r}; "
                f"available: {sorted(RULES)}")
        self._rule = RULES[self._opt_name]
        if self._opt_name == "lbsgd" and self._opt.batch_scale > 1 and \
                self._accum == 1:
            import warnings

            warnings.warn(
                "LBSGD batch_scale>1: the step applies the large-batch lr "
                "warmup every step but does NOT accumulate gradients; pass "
                "accum_steps (or feed the full macro-batch) for the "
                "accumulation half", stacklevel=2)
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
            self._param_names.append(name)
            self._params.append(p)
            self._train_handles.append(p.data())
        params = net.collect_params()
        self._rules = dict(sharding_rules(params, self._mesh))
        if rules:
            self._rules.update(rules)
        _check_rules({n: self._rules.get(n, ()) for n in self._rules},
                     {n: tuple(p.shape) for n, p in params.items()},
                     self._mesh)
        self._wd_mult = [1.0 if (n.endswith("weight") or n.endswith("gamma"))
                         else 0.0 for n in self._param_names]
        self._place_params()
        mp = bool(getattr(self._opt, "multi_precision", False))
        self._routes = opt_rules.Routes(
            [h._data.dtype for h in self._train_handles], mp)
        self._opt_state = [
            opt_rules.init_state(self._rule, self._opt, h._data, mp)
            for h in self._train_handles]
        self._grads32 = self._master_grad_buffers()
        # the aux state as it was before the step (the guard's
        # select-back reads these after the forward wrote the live ones)
        self._aux_before = [torch.empty_like(h._data)
                            for h in self._aux_handles] \
            if self._nan_guard else []
        self.route_counts = dict.fromkeys(self._routes.census(), 0)
        self._t = 0
        # the model bus (publish_to): none armed
        self._bus = None
        self._bus_every = 1
        self._bus_rollback = True
        self._bus_model = None
        self._bus_topk = None
        self._bus_host = None
        self.published_versions = []
        # donate=False: the working set the step updates (its graph's
        # reads) and the tensors handed out, with their version counters
        self._work = None
        self._handed = None
        if not self._donate:
            self._work = ([h._data for h in self._train_handles
                           + self._aux_handles], self._opt_state)
            self._hand_out()
        self._t_dev = torch.zeros((), dtype=torch.float32, device=self._device)
        self._lr_dev = torch.zeros((), dtype=torch.float32,
                                   device=self._device)
        self._one = torch.ones((), dtype=torch.float32, device=self._device)
        self._step_fn = _compile.jit(
            self._step_body, site="trainer",
            token=("step", id(self), self._remat, self._accum, self._donate,
                   self._zero),
            reads=self._step_reads)
        self._predict_fn = _compile.jit(self._predict_body, site="trainer",
                                        token=("predict", id(self)),
                                        reads=self._predict_reads)

    def _place_params(self):
        """Every parameter on the mesh's device, contiguous (the fused
        kernels update the trainable ones in place)."""
        for h in self._train_handles + self._aux_handles:
            if h._data.device != self._device or \
                    not h._data.is_contiguous():
                h._rebind(h._data.detach().to(self._device).contiguous())
        self._placed = True

    # ------------------------------------------------------ donate=False ---
    def _public(self):
        """The tensors handed out: every handle's, then every optimizer
        state slot's."""
        return [h._data for h in self._train_handles + self._aux_handles] \
            + [s for per in self._opt_state for s in per]

    def _hand_out(self):
        """Give every handle and optimizer-state slot a fresh copy of the
        working set (donate=False), and note what was handed out. The
        tensors handed out before are let go first, so that the copies
        take their memory; after a step this runs once the replay is
        enqueued, so the host's work overlaps the card's."""
        self._handed = None
        handles, states = self._work
        with torch.no_grad():
            fresh = [torch.empty_like(t) for t in handles]
            torch._foreach_copy_(fresh, handles)
            per = [[torch.empty_like(s) for s in st] for st in states]
            flat = [s for st in per for s in st]
            if flat:
                torch._foreach_copy_(flat, [s for st in states for s in st])
        for h, t in zip(self._train_handles + self._aux_handles, fresh):
            h._data = t
        self._opt_state = per
        self._handed = [(t, t._version) for t in self._public()]

    def _adopt(self):
        """Copy into the working set each handed-out tensor that was
        rebound or written in place since :meth:`_hand_out`
        (donate=False)."""
        handles, states = self._work
        work = list(handles) + [s for st in states for s in st]
        with torch.no_grad():
            for w, t, (given, version) in zip(work, self._public(),
                                             self._handed):
                if t is given and t._version == version:
                    continue
                if t.shape != w.shape:
                    raise ValueError(
                        f"ShardedTrainer: a parameter or optimizer state "
                        f"was rebound to shape {tuple(t.shape)}; the "
                        f"trainer holds {tuple(w.shape)}")
                w.copy_(t)

    @contextlib.contextmanager
    def _bound(self, hand_out):
        """The handles and optimizer-state slots bound to the working set
        for one call (donate=False; nothing with donate=True); after it,
        fresh copies are handed out (``hand_out``: the call wrote it) or
        the same tensors bound again."""
        if self._donate:
            yield
            return
        self._adopt()
        public = None if hand_out else (list(self._public()),
                                        self._opt_state)
        handles, states = self._work
        for h, t in zip(self._train_handles + self._aux_handles, handles):
            h._data = t
        self._opt_state = states
        try:
            yield
        finally:
            if hand_out:
                self._hand_out()
            else:
                for h, t in zip(self._train_handles + self._aux_handles,
                                public[0]):
                    h._data = t
                self._opt_state = public[1]

    def _master_grad_buffers(self):
        """One float32 view per master, into which its gradient is cast
        each step: slices of one buffer, each starting on a 16-byte
        boundary, so the fused kernel reads them on its 16-byte path and
        its parameter-set table (keyed by pointers) is built once."""
        sizes = [self._train_handles[i].size for i in self._routes.master]
        if not sizes:
            return []
        padded = [-(-n // _ALIGN) * _ALIGN for n in sizes]
        flat = torch.empty(sum(padded), dtype=torch.float32,
                           device=self._device)
        views, at = [], 0
        for i, n, pad in zip(self._routes.master, sizes, padded):
            views.append(flat[at:at + n].view(self._train_handles[i].shape))
            at += pad
        return views

    def _step_reads(self):
        return ([h._data for h in self._train_handles]
                + [h._data for h in self._aux_handles]
                + [s for per in self._opt_state for s in per]
                + self._grads32)

    def _predict_reads(self):
        return [h._data for h in self._train_handles + self._aux_handles]

    @property
    def learning_rate(self):
        """The lr the scheduler gives at the current step, else the set
        one; settable between steps (the step reads it from a device
        scalar, so nothing is rebuilt)."""
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler(self._t))
        return self._lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self.set_learning_rate(lr)

    def set_learning_rate(self, lr):
        """Change the lr between steps; raises UserWarning when a
        scheduler drives it, as ``Optimizer.set_learning_rate`` does."""
        if self._lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already "
                              "been defined.")
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
        a row raise RuntimeError.

        The step's record of the telemetry timeline (``h2d``,
        ``compute``, ``sync``; :meth:`step_report`) opens here, and a step
        that raises abandons it (JAX :662-679)."""
        _tsteps.begin_step(self._t + 1)
        try:
            out = self._step_exec(x, y)
        except BaseException:
            _tsteps.abort()
            raise
        _tsteps.end_step(flops=self._step_flops(),
                         devices=self._mesh.num_devices)
        if self._bus is not None and self._t % self._bus_every == 0:
            self.publish_update()
        return out

    def _step_exec(self, x, y):
        if not self._placed:   # after unshard
            self._place_params()
        t0 = time.perf_counter()
        x_raw, y_raw = self._put_batch(x), self._put_batch(y)
        if _faults.ARMED:
            # raise/delay/kill, or a NaN-poisoned batch for the nan guard
            # to absorb; fired here, in the host code before the
            # (captured) step, never inside its graph (JAX :710-713)
            x_raw = _faults.point("trainer.step", x_raw)
        _tsteps.phase("h2d", (time.perf_counter() - t0) * 1e3)
        self._t += 1
        self._fill_scalars(self._t)
        t0 = time.perf_counter()
        with self._bound(hand_out=True):
            loss, skip = self._step_fn(x_raw, y_raw)
        # the update runs inside the step: "optimizer" stays 0
        _tsteps.phase("compute", (time.perf_counter() - t0) * 1e3)
        for route, n in self._routes.census().items():
            self.route_counts[route] += n
        if self._nan_guard:
            t0 = time.perf_counter()
            self._account_skip(not bool(skip.item()))  # waits for the step
            _tsteps.phase("sync", (time.perf_counter() - t0) * 1e3)
        return NDArray(loss)

    def _fill_scalars(self, t):
        lr = self._lr if self._lr_scheduler is None \
            else float(self._lr_scheduler(t))
        self._t_dev.fill_(float(t))
        self._lr_dev.fill_(lr)

    def _step_flops(self):
        """The flops of one call of the step, counted when its entry was
        made (the ``mfu_xla`` numerator), or None."""
        from ..telemetry import costs

        return costs.flops_for(self._step_fn._token_key)

    def step_report(self):
        """The most recent step's telemetry record (JAX :690-697):
        ``step``, ``duration_ms``, ``phases`` (``data_wait``, ``h2d``,
        ``compute``, ``optimizer``, ``sync``, and ``other``, the rest of
        the duration), ``t_wall`` and, once the step's flops are counted,
        ``flops`` and ``mfu_xla``. None before the first step, or with
        telemetry off."""
        return _tsteps.last()

    def warmup(self, x, y):
        """Capture the step for batches shaped like ``x`` / ``y`` (an
        NDArray, a tensor, a numpy array or a ``(shape, dtype)`` pair)
        without taking a step (JAX :395-414). The capture's eager first
        call updates the state, so the parameters, aux state, optimizer
        state, step count, skip counters and ``mx.random``'s generator are
        snapshotted first and put back after; the next :meth:`step` of
        this signature is a replay. A signature already captured is left
        as it is. Returns the JAX package's warm-up report with an empty
        manifest (the port has none: a CUDA graph does not serialize)."""
        if not self._placed:   # after unshard
            self._place_params()
        x_raw = self._placeholder(x)
        y_raw = self._placeholder(y)
        with self._bound(hand_out=False):
            if not self._step_fn.cached(x_raw, y_raw):
                self._warm(x_raw, y_raw)
        return {"entries": 0, "compiled": 0, "disk": 0, "cached": 0,
                "pending": 0, "errors": [], "time": time.time()}

    def _warm(self, x_raw, y_raw):
        """The step's entry made for ``(x_raw, y_raw)`` and every state
        its first call changed put back."""
        gen = _random.generator(self._device)
        rng = (_random.current_seed(), gen.get_state())
        counters = (self._t, self.skipped_steps, self.consecutive_skips)
        state = list(self._state_tensors().values())
        snap = [t.clone() for t in state]
        try:
            self._fill_scalars(self._t + 1)
            self._step_fn(x_raw, y_raw)
        finally:
            with torch.no_grad():
                torch._foreach_copy_(state, snap)
            _random.set_state(rng[0], rng[1], self._device)
            self._t, self.skipped_steps, self.consecutive_skips = counters

    def _placeholder(self, x):
        """A batch on the device: ``x`` itself, or zeros of a
        ``(shape, dtype)`` pair's shape."""
        if isinstance(x, tuple):
            shape, dtype = _batch_spec(x, self._device)
            return torch.zeros(shape, dtype=dtype, device=self._device)
        return self._put_batch(x)

    def aot_lower(self, x, y):
        """Trace the step for batches shaped like ``x`` / ``y`` (an
        NDArray, a tensor, a numpy array or a ``(shape, dtype)`` pair)
        on fake tensors (``FakeTensorMode``) without running it: nothing
        runs on the device, no kernel launches, no state changes and no
        random draw (JAX :416-455). Returns a :class:`Lowered`:
        ``as_text()`` lists the ops the step dispatches (the hand-written
        kernels by family), ``flops`` counts them, ``compile()`` captures
        it (:meth:`warmup`). JAX's HLO collective census waits
        for ``analysis.distcheck`` (ROADMAP.md item A11)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        from ..telemetry import costs

        x_spec = _batch_spec(x, self._device)
        y_spec = _batch_spec(y, self._device)
        handles = self._train_handles + self._aux_handles
        gen = _random.generator(self._device)
        rng = gen.get_state()
        with self._bound(hand_out=False):
            saved = ([h._data for h in handles], self._opt_state,
                     self._grads32, self._aux_before, self._t_dev,
                     self._lr_dev, self._one)
            try:
                with FakeTensorMode(allow_non_fake_inputs=True) as fake:
                    def f(t):
                        return fake.from_tensor(t)

                    for h in handles:
                        h._data = f(h._data)
                    self._opt_state = [[f(t) for t in per]
                                       for per in self._opt_state]
                    self._grads32 = [f(t) for t in self._grads32]
                    self._aux_before = [f(t) for t in self._aux_before]
                    self._t_dev, self._lr_dev, self._one = (
                        f(self._t_dev), f(self._lr_dev), f(self._one))
                    fx = torch.empty(x_spec[0], dtype=x_spec[1],
                                     device=self._device)
                    fy = torch.empty(y_spec[0], dtype=y_spec[1],
                                     device=self._device)
                    with _recorder_class()() as rec, \
                            costs.counting() as count, _compile.nested():
                        self._step_body(fx, fy)
            finally:
                for h, t in zip(handles, saved[0]):
                    h._data = t
                (self._opt_state, self._grads32, self._aux_before,
                 self._t_dev, self._lr_dev, self._one) = saved[1:]
        if not torch.equal(gen.get_state(), rng):
            raise MXNetError("ShardedTrainer.aot_lower: the traced step "
                             "drew from mx.random's generator")
        return Lowered(self, x_spec, y_spec, rec.ops, count)

    def _micro(self, x_raw, y_raw, weights, leaves, subs):
        """The mean loss of one (micro)batch and every trainable
        parameter's gradient; with ``remat`` the forward and the loss run
        under ``torch.utils.checkpoint`` and are recomputed in the
        backward (the JAX step's ``jax.checkpoint(run_net)``, :492-494)."""
        def run(x, y):
            out = self._net.forward(NDArray(x))
            return self._loss_fn(out, NDArray(y)).mean()._data

        with substitute(subs), autograd.record(train_mode=True):
            loss = _recomputed(run, x_raw, y_raw) if self._remat \
                else run(x_raw, y_raw)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(weights, grads)]
        return loss.detach(), grads

    def _loss_and_grads(self, x_raw, y_raw):
        """The batch's mean loss and the trainable parameters' gradients,
        as the step feeds them to the guard and the update.

        With ``accum_steps = k`` the batch is cut into ``k`` microbatches
        (views of the batch, which nothing in the step overwrites); each
        runs its forward and backward in turn, its gradients added in
        float32 to accumulators zeroed here, and BatchNorm's statistics
        carry from one to the next, as the JAX scan's carry (:502-541).
        The summed gradients and loss are divided by ``k`` once."""
        weights = [h._data for h in self._train_handles]
        leaves = [w.detach().requires_grad_(True) for w in weights]
        subs = {p: NDArray(leaf) for p, leaf in zip(self._params, leaves)}
        k = self._accum
        if k == 1:
            return self._micro(x_raw, y_raw, weights, leaves, subs)
        b = x_raw.shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by accum_steps {k}")
        xs = x_raw.reshape((k, b // k) + tuple(x_raw.shape[1:]))
        ys = y_raw.reshape((k, b // k) + tuple(y_raw.shape[1:]))
        acc = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
               for w in weights]
        loss = torch.zeros((), dtype=torch.float32, device=x_raw.device)
        for i in range(k):
            part, grads = self._micro(xs[i], ys[i], weights, leaves, subs)
            torch._foreach_add_(acc, [g.float() for g in grads])
            loss = loss + part.float()
            del grads
        torch._foreach_div_(acc, float(k))
        return loss / k, [a if w.dtype == torch.float32 else a.to(w.dtype)
                          for a, w in zip(acc, weights)]

    def _step_body(self, x_raw, y_raw):
        """The step on the device: ``(loss, skip flag or None)``. The
        graph a capture records (nothing here touches the host): the
        loss and gradients (:meth:`_loss_and_grads`), the guard, and one
        optimizer launch."""
        weights = [h._data for h in self._train_handles]
        auxs = [h._data for h in self._aux_handles]
        if self._aux_before:
            torch._foreach_copy_(self._aux_before, auxs)
        loss, grads = self._loss_and_grads(x_raw, y_raw)
        skip = self._non_finite(loss, grads) if self._nan_guard else None
        wds = [self._wd * m for m in self._wd_mult]
        with torch.no_grad():
            opt_rules.apply(self._rule, self._opt, self._routes, weights,
                            grads, self._opt_state, self._grads32,
                            self._lr_dev, wds, self._t_dev, skip)
            if skip is not None:
                for live, old in zip(auxs, self._aux_before):
                    live.copy_(torch.where(skip != 0, old, live))
        return loss, skip

    def _non_finite(self, loss, grads):
        """A float32 device flag, non-zero when the loss or a gradient
        holds a value that is not finite. Float32 tensors go through one
        fused check (scaling by 1.0, exact); PyTorch's CUDA version of it
        takes no bfloat16, so half-precision ones go through one
        multi-tensor max-norm each, which is not finite exactly when a
        value is not."""
        skip = torch.zeros(1, dtype=torch.float32, device=self._device)
        tensors = [loss.reshape(1)] + grads
        full = [t for t in tensors if t.dtype == torch.float32]
        half = [t for t in tensors if t.dtype != torch.float32]
        if full:
            torch._amp_foreach_non_finite_check_and_unscale_(full, skip,
                                                             self._one)
        if half:
            norms = torch._foreach_norm(half, float("inf"))
            skip.add_(~torch.stack(norms).isfinite().all())
        return skip

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
                "total): the run has diverged; lower the learning rate, "
                "check the data pipeline, or resume from the last good "
                "checkpoint")

    def predict(self, x):
        """Inference forward (train mode off, nothing recorded); a
        captured forward per batch signature."""
        if not self._placed:   # after unshard
            self._place_params()
        with self._bound(hand_out=False):
            return NDArray(self._predict_fn(self._put_batch(x)))

    def _predict_body(self, x_raw):
        with autograd.pause(train_mode=False):
            return self._net.forward(NDArray(x_raw))._data

    # -------------------------------------------------------- checkpoint ---
    def _state_tensors(self):
        """``{key: tensor}`` of every array entry, in key order."""
        out = {}
        for i, h in enumerate(self._train_handles):
            out[f"p{i}"] = h._data
        for i, h in enumerate(self._aux_handles):
            out[f"a{i}"] = h._data
        for i, per in enumerate(self._opt_state):
            for j, s in enumerate(per):
                out[f"s{i}_{j}"] = s
        return out

    def _ckpt_keys(self):
        """The entry keys, positional (``collect_params`` order), so that
        a fresh process with other gluon prefixes can resume."""
        keys = ["__t__", "__rng_seed__", "__rng_key__", "__names__"]
        if self._lr_scheduler is not None:
            keys.append("__sched__")
        return keys + list(self._state_tensors())

    def _state_payload(self):
        """The checkpoint as ``{key: NDArray}`` on the host."""
        names = "\n".join(self._param_names + self._aux_names)
        payload = {
            "__t__": NDArray(torch.tensor(self._t, dtype=torch.int32)),
            "__rng_seed__": NDArray(torch.tensor(_random.current_seed(),
                                                 dtype=torch.int32)),
            "__rng_key__": NDArray(_random.get_state(self._device)),
            "__names__": _bytes_array(names.encode()),
        }
        if self._lr_scheduler is not None:
            # schedulers are pure, but base_lr and the milestones ride along
            payload["__sched__"] = _bytes_array(
                pickle.dumps(self._lr_scheduler))
        for key, t in self._state_tensors().items():
            payload[key] = NDArray(t.detach().to("cpu", copy=True))
        return payload

    def save_states(self, fname):
        """Write parameters, aux state, optimizer state, the step count,
        the random state and the scheduler to one file in the
        ``mx.nd.save`` container (bfloat16 as its uint16 bits), with an
        atomic write (tmp + fsync + ``os.replace``)."""
        from ..checkpoint import atomic_write

        payload = self._state_payload()
        atomic_write(fname, lambda tmp: _nd_utils.save(tmp, payload))

    def load_states(self, fname):
        """Restore a ``save_states`` file of this package or the JAX
        package, into this trainer's tensors and dtypes. The key set and
        every shape are checked before anything changes, so a failed load
        leaves the trainer as it was."""
        if not os.path.exists(fname):
            raise FileNotFoundError(
                f"trainer state file not found: {fname!r}")
        try:
            arrays = _nd_utils.load(fname, ctx=cpu())
        except Exception as e:
            raise ValueError(
                f"corrupt trainer state file {fname!r}: "
                f"{type(e).__name__}: {e} (truncated write? load through "
                "CheckpointManager.resume to fall back to the previous "
                "good checkpoint)") from e
        expected, got = set(self._ckpt_keys()), set(arrays)
        if expected != got:
            raise ValueError(
                "checkpoint does not match this trainer: missing "
                f"{sorted(expected - got)[:5]}, unexpected "
                f"{sorted(got - expected)[:5]} (param count or optimizer "
                "differs)")
        targets = self._state_tensors()
        for key, t in targets.items():
            if tuple(arrays[key].shape) != tuple(t.shape):
                names = bytes(arrays["__names__"]._data.numpy()).decode()
                raise ValueError(
                    f"checkpoint does not match this trainer: entry "
                    f"{key!r} has shape {tuple(arrays[key].shape)}, trainer "
                    f"expects {tuple(t.shape)} (saved param order: {names})")
        sched = None
        if self._lr_scheduler is not None:
            sched = _sched.loads(arrays["__sched__"]._data.numpy())
        with torch.no_grad():
            for key, t in targets.items():
                t.copy_(arrays[key]._data)
        if not self._donate:   # the copies went to the handed-out tensors
            with self._bound(hand_out=True):
                pass
        self._t = int(arrays["__t__"].asscalar())
        self._step_fn.clear()   # the next step captures anew
        if sched is not None:
            self._lr_scheduler = sched
        _random.set_state(int(arrays["__rng_seed__"].asscalar()),
                          arrays["__rng_key__"]._data, self._device)

    def topology_meta(self):
        """The JSON-able topology record of a checkpoint's manifest entry
        (``meta.topology``), in the JAX package's schema. Arrays are
        saved in host layout, so the record describes and never
        interprets."""
        from .. import checkpoint as _ckpt

        return {"format": "canonical-host-v1",
                "mesh": self._mesh.describe(),
                "param_sharding": {n: list(self._rules.get(n, ()))
                                   for n in self._param_names},
                "zero": self._zero, "host": _ckpt.host_metadata()}

    def save_checkpoint(self, manager, epoch, meta=None, data_iter=None):
        """Write the trainer's state through a ``checkpoint.
        CheckpointManager`` (atomic write, CRC-checked manifest entry with
        ``meta.topology``, keep-N rotation). ``data_iter`` (an iterator
        with ``state_dict()``: ImageRecordIter, TokenRecordIter,
        NDArrayIter, PrefetchingIter) has its stream position recorded as
        ``meta.data_state``. Returns ``{name: path}``."""
        payload = self._state_payload()
        meta = dict(meta or {})
        meta.setdefault("topology", self.topology_meta())
        if data_iter is not None and "data_state" not in meta:
            meta["data_state"] = data_iter.state_dict()
        return manager.save(
            epoch, {"states": lambda tmp: _nd_utils.save(tmp, payload)},
            step=self._t, meta=meta)

    @staticmethod
    def _topology_changed(saved, current):
        """The differences between two topology records, as text (none:
        a resume on the saved topology; JAX :1070-1084)."""
        diffs = []
        sm, cm = saved.get("mesh") or {}, current.get("mesh") or {}
        if sm.get("axes") != cm.get("axes"):
            diffs.append(f"mesh axes {sm.get('axes')} -> {cm.get('axes')}")
        if sm.get("num_devices") != cm.get("num_devices"):
            diffs.append(f"device count {sm.get('num_devices')} -> "
                         f"{cm.get('num_devices')}")
        sh, ch = saved.get("host") or {}, current.get("host") or {}
        if sh.get("process_count") != ch.get("process_count"):
            diffs.append(f"process count {sh.get('process_count')} -> "
                         f"{ch.get('process_count')}")
        return diffs

    def resume(self, manager, reshard=None, data_iter=None):
        """Restore the latest good checkpoint of ``manager`` (a corrupt
        newest file falls back to the previous good one). Returns the
        manifest entry, or None when none is recorded. ``data_iter`` is
        set to the entry's ``meta.data_state`` where it has one: the next
        batch is the first one the saved run had not seen.

        The entry's ``meta.topology`` is compared with this trainer's
        (JAX :1086-1157): on a mismatch (a JAX checkpoint from an
        8-device mesh, say) the host-layout arrays load onto this mesh
        with a warning, unless ``reshard=False`` (or, when ``reshard`` is
        None, ``MXNET_TPU_PREEMPT_RESHARD=0``), which raises a
        ``ValueError`` naming both meshes."""
        res = manager.resume()
        if res is None:
            return None
        entry, paths = res
        saved_topo = (entry.get("meta") or {}).get("topology")
        diffs = self._topology_changed(saved_topo, self.topology_meta()) \
            if saved_topo else []
        if diffs:
            if reshard is None:
                reshard = os.environ.get("MXNET_TPU_PREEMPT_RESHARD",
                                         "1") != "0"
            saved_mesh = (saved_topo.get("mesh") or {}).get("axes")
            if not reshard:
                axis_notes = "".join(
                    "; saved " + self._mesh.axis_error(a)
                    for a in sorted(saved_mesh or {})
                    if a not in self._mesh.axis_sizes)
                raise ValueError(
                    f"checkpoint epoch {entry['epoch']} was written on "
                    f"DeviceMesh({saved_mesh}) but this trainer runs on "
                    f"{self._mesh!r} ({'; '.join(diffs)}{axis_notes}) and "
                    "resharding is disabled: resume on the original "
                    "topology, or allow resharding (reshard=True / unset "
                    "MXNET_TPU_PREEMPT_RESHARD=0) to place the host-layout "
                    "arrays on this mesh")
            warnings.warn(
                f"resuming checkpoint epoch {entry['epoch']} across a "
                f"topology change ({'; '.join(diffs)}): arrays reshard "
                f"from DeviceMesh({saved_mesh}) onto {self._mesh!r}; "
                "numerics match the original trajectory up to reduction "
                "order (bit-exact only on the saved topology)",
                stacklevel=2)
        self.load_states(paths["states"])
        data_state = (entry.get("meta") or {}).get("data_state")
        if data_iter is not None and data_state is not None:
            data_iter.load_state_dict(data_state)
        return entry

    # --------------------------------------------------------- model bus ---
    def publish_to(self, bus, every=1, compress_threshold=None,
                   model=None, topk=None, rollback=True):
        """Stream live weight updates into a model bus: every ``every``-th
        step publishes a version-stamped record of the current parameters
        (and aux state) into ``bus`` (a directory path or a
        :class:`~mxnet_tpu_torch.modelbus.ModelBus`) for serving
        processes to apply between batches.

        Small parameters ride as full tensors; those of at least
        ``compress_threshold`` elements ride int8 per-row compressed;
        ``topk`` ({param_name: k}) publishes only the k most-changed rows
        of the named parameters. A non-finite update is never published.
        With ``rollback`` (the default), a publish that finds the bus head
        quarantined by a subscriber first re-publishes the newest good
        version. Returns the :class:`~mxnet_tpu_torch.modelbus.ModelBus`.
        """
        from ..modelbus import ModelBus

        self._bus = bus if isinstance(bus, ModelBus) \
            else ModelBus(bus, compress_threshold=compress_threshold)
        self._bus_every = max(1, int(every))
        self._bus_rollback = bool(rollback)
        self._bus_model = model
        self._bus_topk = dict(topk) if topk else None
        return self._bus

    def publish_update(self):
        """Publish the current weights to the armed bus now (the step
        calls this every ``every`` steps; explicit calls are fine too).
        Returns the published version, or None (a non-finite update, or
        no bus armed)."""
        if self._bus is None:
            return None
        params, aux = self._publish_host_copy()
        if self._bus_topk:
            # the bus keeps the values it published as the next record's
            # base: those must not be the host buffers the next copy reuses
            params = [(n, a.copy() if n in self._bus_topk else a)
                      for n, a in params]
        if self._bus_rollback:
            self._bus.auto_rollback(worker="publisher")
        version = self._bus.publish(params, step=self._t, aux=aux,
                                    model=self._bus_model,
                                    topk=self._bus_topk)
        if version is not None:
            self.published_versions.append(version)
        return version

    def _publish_host_copy(self):
        """``(params, aux)`` as ``[(name, host array)]``: every tensor
        copied to the host by one synchronised device-to-host copy after
        the step (into pinned buffers kept from one publish to the next,
        on a card)."""
        handles = self._train_handles + self._aux_handles
        for h in handles:
            if h._data.dtype == torch.bfloat16:
                raise MXNetError(
                    "ShardedTrainer.publish_update: bfloat16 parameters "
                    "have no numpy dtype in mxnet_tpu_torch, so the bus "
                    "cannot carry them")
        if self._device.type != "cuda":
            arrays = [h._data.detach().to("cpu", copy=True).numpy()
                      for h in handles]
        else:
            if self._bus_host is None:
                self._bus_host = [torch.empty(h._data.shape,
                                              dtype=h._data.dtype,
                                              pin_memory=True)
                                  for h in handles]
            torch._foreach_copy_(self._bus_host, [h._data for h in handles],
                                 non_blocking=True)
            torch.cuda.current_stream(self._device).synchronize()
            arrays = [buf.numpy() for buf in self._bus_host]
        n = len(self._train_handles)
        return (list(zip(self._param_names, arrays[:n])),
                list(zip(self._aux_names, arrays[n:])))

    def unshard(self, ctx=None):
        """Copy every parameter and aux state to ``ctx`` (default: the
        current context) and rebind the handles, for eager use or export
        (JAX :1239-1247). The next :meth:`step` or :meth:`predict` puts
        them back on the mesh's device."""
        from ..context import current_context

        dev = (ctx or current_context()).torch_device()
        for h in self._train_handles + self._aux_handles:
            h._data = h._data.detach().to(dev, copy=True)
        self._placed = False
        if not self._donate:   # the copies are what was handed out
            self._handed = [(t, t._version) for t in self._public()]

    @property
    def mesh(self):
        return self._mesh
