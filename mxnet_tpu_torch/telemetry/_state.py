"""Shared telemetry switch (counterpart of
``mxnet_tpu/telemetry/_state.py``): one module-global that the hot-path
check in :func:`mxnet_tpu_torch.telemetry.flight.rec` reads as a single
attribute load.

``MXNET_TPU_TELEMETRY=0`` disables the flight recorder at process start;
:func:`set_enabled` flips it at runtime.
"""
from __future__ import annotations

import os

enabled = os.environ.get("MXNET_TPU_TELEMETRY", "1").lower() \
    not in ("0", "false", "off")


def set_enabled(on) -> bool:
    """Toggle push instrumentation; returns the previous state."""
    global enabled
    prev = enabled
    enabled = bool(on)
    return prev
