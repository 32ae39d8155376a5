"""Learning-rate schedules.

Counterpart of ``mxnet_tpu/lr_scheduler.py``: the ``LRScheduler`` base
with its linear or constant warmup ramp, ``FactorScheduler``,
``MultiFactorScheduler``, ``PolyScheduler`` and ``CosineScheduler``, as
pure maps ``num_update -> lr`` computed from the absolute update count
(the JAX package's departure from MXNet 1.x, whose schedulers walk a
mutable count forward). A call is a pure function of its argument, so a
schedule can be replayed, evaluated out of order and pickled into a
checkpoint (``ShardedTrainer.save_states``'s ``__sched__``).

The arguments are checked as there and the attributes have the same
names, so that a scheduler the JAX package pickled unpickles into the
class of the same name here (:func:`loads`). Every value is a Python
float, computed in the JAX package's order, so both packages give the
same learning rate bit for bit.
"""
from __future__ import annotations

import io
import math
import pickle

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "loads"]


class LRScheduler:
    """Map an update count to a learning rate. Subclasses implement
    ``_decay(num_update)`` over the absolute update count; the base class
    owns the warmup ramp."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        if warmup_steps < 0:
            raise ValueError(f"warmup_steps must be >= 0, got {warmup_steps}")
        if warmup_mode not in ("linear", "constant"):
            raise ValueError(
                f"warmup_mode must be 'linear' or 'constant', "
                f"got {warmup_mode!r}")
        if warmup_begin_lr > base_lr:
            raise ValueError(
                f"warmup_begin_lr ({warmup_begin_lr}) must not exceed "
                f"base_lr ({base_lr})")
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_mode = warmup_mode

    @property
    def warmup_final_lr(self):
        # follows base_lr, which an optimizer may overwrite after
        # construction, so that the ramp stays continuous
        return self.base_lr

    def get_warmup_lr(self, num_update):
        """The lr on the warmup ramp (``num_update < warmup_steps``)."""
        if self.warmup_mode == "constant":
            return self.warmup_begin_lr
        frac = num_update / self.warmup_steps
        return self.warmup_begin_lr + \
            frac * (self.warmup_final_lr - self.warmup_begin_lr)

    def _decay(self, num_update):
        raise NotImplementedError

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self._decay(num_update)


def _check_factor(factor):
    if factor > 1.0:
        raise ValueError(
            f"a decay factor > 1 would grow the lr, got {factor}")


class FactorScheduler(LRScheduler):
    """Multiply the lr by ``factor`` once every ``step`` updates, with a
    floor at ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        _check_factor(factor)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def _decay(self, num_update):
        # whole windows of `step` updates completed before this one
        k = max(0, (num_update - 1) // self.step) if num_update > 0 else 0
        return max(self.base_lr * self.factor ** k, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """Multiply the lr by ``factor`` at each milestone in ``step`` (a
    strictly increasing list of update counts)."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of milestones")
        if any(s < 1 for s in step):
            raise ValueError(f"milestones must be >= 1, got {step}")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError(f"milestones must strictly increase, got {step}")
        _check_factor(factor)
        self.step = step
        self.factor = factor

    def _decay(self, num_update):
        k = sum(1 for s in self.step if num_update > s)
        return self.base_lr * self.factor ** k


class _SpanScheduler(LRScheduler):
    """Schedules that anneal base_lr -> final_lr over the ``max_update -
    warmup_steps`` span and then hold final_lr."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError(
                f"max_update must be a positive int, got {max_update!r}")
        if warmup_steps >= max_update:
            raise ValueError(
                f"warmup_steps ({warmup_steps}) must be < max_update "
                f"({max_update}): the anneal span would be empty")
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def _shape(self, frac):
        """The annealing profile: 1 -> 0 as frac goes 0 -> 1."""
        raise NotImplementedError

    def _decay(self, num_update):
        t = num_update - self.warmup_steps
        frac = min(t, self.max_steps) / self.max_steps
        return self.final_lr + \
            (self.base_lr - self.final_lr) * self._shape(frac)


class PolyScheduler(_SpanScheduler):
    """Polynomial annealing: ``(1 - frac) ** pwr`` of the lr span."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(max_update, base_lr, final_lr, warmup_steps,
                         warmup_begin_lr, warmup_mode)
        self.power = pwr

    def _shape(self, frac):
        return (1.0 - frac) ** self.power


class CosineScheduler(_SpanScheduler):
    """Half-cosine annealing of the lr span."""

    def _shape(self, frac):
        return 0.5 * (1.0 + math.cos(math.pi * frac))


_CLASSES = {c.__name__: c for c in (
    FactorScheduler, MultiFactorScheduler, PolyScheduler, CosineScheduler)}
# the modules whose pickled schedulers read as this module's classes
_MODULES = ("mxnet_tpu.lr_scheduler", __name__)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _MODULES and name in _CLASSES:
            return _CLASSES[name]
        raise pickle.UnpicklingError(
            f"a pickled lr scheduler may name only the schedulers of "
            f"{' or '.join(_MODULES)}, not {module}.{name}")


def loads(data):
    """A scheduler from its pickle, written by this package or by the JAX
    package (``mxnet_tpu.lr_scheduler.<Class>`` reads as the class of the
    same name here, without importing the JAX package). Any other class
    in the pickle is refused with ``pickle.UnpicklingError``."""
    return _Unpickler(io.BytesIO(bytes(data))).load()
