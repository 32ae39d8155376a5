"""Dynamic loss scaling (counterpart of ``mxnet_tpu/amp/loss_scaler.py``;
MXNet 1.x ``python/mxnet/contrib/amp/loss_scaler.py``).

float16 training needs it (small gradients underflow); bfloat16 has
float32's exponent range and runs without a scaler. The scale halves on
an overflow and doubles after ``scale_window`` steps without one. The
overflow check reads every gradient once and writes none: one
multi-tensor largest-magnitude pass (``torch._foreach_norm`` of order
inf, which is inf or NaN exactly when its tensor holds one) and one
read-back a step, where the JAX package reads each gradient's check back
in turn. The loss scale itself comes out in the optimizer's
``rescale_grad`` (``amp.scale_loss``), not in a pass over the gradients.
"""
from __future__ import annotations

import torch

__all__ = ["LossScaler"]


class LossScaler:
    def __init__(self, init_scale=2.0 ** 16, scale_factor=2.0,
                 scale_window=2000, tolerance=0.05):
        self.loss_scale = float(init_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        self._tolerance = tolerance
        self._skipped = 0
        self._total = 0

    def has_overflow(self, params):
        """Whether any gradient of ``params`` (Parameters, NDArrays or
        tensors) holds an inf or a NaN."""
        by_device = {}
        for p in params:
            g = p.grad() if hasattr(p, "grad") and callable(p.grad) else p
            g = getattr(g, "_data", g)
            by_device.setdefault(g.device, []).append(g)
        bad = any(not bool(torch.stack(torch._foreach_norm(
            grads, float("inf"))).isfinite().all())
            for grads in by_device.values())
        self._total += 1
        if bad:
            self._skipped += 1
        return bad

    def update_scale(self, overflow):
        """Halve the scale on an overflow (not below 1); double it after
        ``scale_window`` steps without one."""
        if overflow:
            self.loss_scale = max(self.loss_scale / self._scale_factor, 1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
        if self._unskipped == self._scale_window:
            self.loss_scale *= self._scale_factor
            self._unskipped = 0
