"""Device / Context model.

Counterpart of ``mxnet_tpu/context.py``: a ``(device_type, device_id)``
pair that places NDArrays. Here a Context resolves to a
``torch.device``: ``cpu`` or ``gpu`` (a CUDA card).

The default context is ``gpu(0)``, not ``cpu(0)`` as in the JAX package:
the port runs on the card unless the caller asks for the CPU
(``ctx=mx.cpu()``). Resolving a ``gpu`` context on a host without a
usable CUDA card raises :class:`MXNetError`; nothing carries on silently
on the CPU.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "num_gpus", "current_context"]


# the cards a context resolved to (``nd.waitall`` synchronises them)
_TOUCHED: set = set()


class Context:
    """A device context. Acts as a context manager (``with mx.cpu():``)
    that sets the thread-local default device."""

    _tls = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, device_type.device_id
        if device_type not in ("cpu", "gpu"):
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __enter__(self):
        stack = getattr(Context._tls, "stack", None)
        if stack is None:
            stack = Context._tls.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._tls.stack.pop()

    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context names. A ``gpu`` context
        raises when the card is missing."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        n = num_gpus()
        if self.device_id >= n:
            raise MXNetError(
                f"context {self} needs a CUDA card but {n} are visible; "
                "pass ctx=mx.cpu() to run on the CPU")
        _TOUCHED.add(self.device_id)
        return torch.device("cuda", self.device_id)

    @staticmethod
    def from_device(device: torch.device) -> "Context":
        if device.type == "cpu":
            return Context("cpu", 0)
        if device.type == "cuda":
            return Context("gpu", device.index or 0)
        raise MXNetError(f"no Context for torch device {device}")


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def num_gpus() -> int:
    """Number of visible CUDA cards (0 without a usable driver)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context() -> Context:
    """The active default context: the innermost ``with ctx:`` on this
    thread, else ``gpu(0)``."""
    stack = getattr(Context._tls, "stack", None)
    return stack[-1] if stack else Context("gpu", 0)
