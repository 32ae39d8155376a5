"""Shared telemetry switch (counterpart of
``mxnet_tpu/telemetry/_state.py``): one module-global that the hot-path
check in :func:`mxnet_tpu_torch.telemetry.flight.rec` reads as a single
attribute load.

``MXNET_TPU_TELEMETRY=0`` disables every push instrumentation point (the
flight recorder, the step timeline, memory sampling, the flop count of a
new compiled entry, spans) at process start; :func:`set_enabled` flips it
at runtime. Pull-based exports (the registry's collectors) answer a
scrape either way.
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
