"""Telemetry (counterpart of ``mxnet_tpu/telemetry``): the shared switch
(``_state``) and the flight recorder (``flight``) that the model bus and
serving write their events to.

The metrics registry and its Prometheus/JSON export, the request and
step tracer, device-memory sampling, executable cost records and the
fleet aggregation are not ported.
"""
from . import _state, flight
from ._state import set_enabled

__all__ = ["flight", "set_enabled", "enabled"]


def enabled() -> bool:
    """Whether push instrumentation (the flight recorder) is on."""
    return _state.enabled
