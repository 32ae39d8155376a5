"""Train-mode scopes.

Counterpart of the scope half of ``mxnet_tpu/autograd.py``: the
thread-local training flag that Dropout reads, and the ``pause`` /
``train_mode`` / ``predict_mode`` scopes that set it. Serving runs its
forward under ``pause(train_mode=False)`` inside
``torch.inference_mode()``. ``record`` / ``backward`` come with the
training slice.
"""
from __future__ import annotations

import threading

__all__ = ["pause", "train_mode", "predict_mode", "is_training",
           "set_training"]

_tls = threading.local()


def is_training() -> bool:
    return getattr(_tls, "training", False)


def set_training(train: bool) -> bool:
    """Set the flag on this thread; returns the previous value."""
    prev = is_training()
    _tls.training = bool(train)
    return prev


class _TrainingScope:
    def __init__(self, train):
        self._train = train
        self._prev = None

    def __enter__(self):
        self._prev = set_training(self._train)
        return self

    def __exit__(self, *exc):
        set_training(self._prev)


def pause(train_mode: bool = False):
    """Scope that runs with the training flag set to ``train_mode``
    (nothing is recorded in this slice)."""
    return _TrainingScope(train_mode)


def train_mode():
    return _TrainingScope(True)


def predict_mode():
    return _TrainingScope(False)
