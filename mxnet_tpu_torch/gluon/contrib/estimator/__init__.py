"""The Estimator training facade (counterpart of
``mxnet_tpu/gluon/contrib/estimator/``, MXNet 1.x
``python/mxnet/gluon/contrib/estimator/``)."""
from __future__ import annotations

from .estimator import Estimator
from .event_handler import (BatchBegin, BatchEnd, CheckpointHandler,
                            EarlyStoppingHandler, EpochBegin, EpochEnd,
                            LoggingHandler, StoppingHandler, TrainBegin,
                            TrainEnd)

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StoppingHandler", "LoggingHandler",
           "CheckpointHandler", "EarlyStoppingHandler"]
