"""Serving defaults (counterpart of ``mxnet_tpu/serving/config.py``).

    buckets      padded batch sizes a model runs at (default 2|4|8|16|32)
    max_queue    rows waiting per model before submit() fast-rejects with
                 ServerBusyError (default 1024)
    max_wait_ms  how long the collector holds an underfull batch waiting
                 for batch-mates (default 2.0)
    timeout_ms   default ServingFuture.result() deadline (default 30000)

Callers override them per server or model (``ModelServer(max_queue=...)``,
``ServedModel.from_block(buckets=...)``). The ``MXNET_TPU_SERVING``
environment grammar and ``configure()`` are not ported yet.
"""
from __future__ import annotations

__all__ = ["DEFAULTS", "coerce"]

DEFAULTS = {
    "buckets": (2, 4, 8, 16, 32),
    "max_queue": 1024,
    "max_wait_ms": 2.0,
    "timeout_ms": 30000.0,
}


def coerce(key, val):
    """Validate one setting; returns its canonical value."""
    if key == "buckets":
        buckets = tuple(sorted({int(b) for b in val}))
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"bad serving buckets {val!r}")
        return buckets
    if key == "max_queue":
        n = int(val)
        if n < 1:
            raise ValueError(f"serving max_queue must be >= 1, got {n}")
        return n
    if key in ("max_wait_ms", "timeout_ms"):
        f = float(val)
        if f < 0:
            raise ValueError(f"serving {key} must be >= 0, got {f}")
        return f
    raise ValueError(
        f"unknown serving option {key!r}; expected one of {sorted(DEFAULTS)}")
