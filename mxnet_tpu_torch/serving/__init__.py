"""Inference serving: a continuous-batching predict server.

Counterpart of ``mxnet_tpu/serving``: :class:`ServedModel` /
:class:`ModelContainer` (``model.py``), :class:`BucketBatcher`
(``batcher.py``) and :class:`ModelServer` (``server.py``)::

    from mxnet_tpu_torch import serving

    c = serving.ModelContainer()
    c.add_block("clf", net, example_shape=(128,))   # weights to the card
    server = serving.ModelServer(c).start()
    server.warmup()
    y = server.predict("clf", x)          # or submit() -> future
    server.drain()                        # answer admitted, stop
"""
from .batcher import BucketBatcher, ServingFuture
from .config import DEFAULTS
from .errors import (ModelNotFound, RequestError, RequestTimeout,
                     ServerBusyError, ServerDrainingError, ServingError)
from .metrics import ModelMetrics
from .model import ModelContainer, ServedModel
from .server import ModelServer

__all__ = ["BucketBatcher", "ServingFuture", "DEFAULTS", "ModelNotFound",
           "RequestError", "RequestTimeout", "ServerBusyError",
           "ServerDrainingError", "ServingError", "ModelMetrics",
           "ModelContainer", "ServedModel", "ModelServer"]
