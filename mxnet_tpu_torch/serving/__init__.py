"""Inference serving: a continuous-batching predict server with live
weight updates.

Counterpart of ``mxnet_tpu/serving``:

* :class:`ServedModel` / :class:`ModelContainer` (``model.py``): models
  served at a ladder of padded batch buckets, each bucket one CUDA graph
  on the card; :meth:`ServedModel.swap_params` writes new weights into
  the tensors those graphs read, between two batches, with nothing
  captured again;
* :class:`BucketBatcher` (``batcher.py``): continuous batching with
  admission control, the priority classes of :data:`PRIORITIES`,
  per-request deadlines (:class:`DeadlineExceeded`) and the prediction
  cache (:class:`PredictionCache`, ``cache.py``);
* :class:`ModelServer` (``server.py``): submit/predict, ``stats()``,
  :meth:`ModelServer.watch_bus` (the subscriber of
  :mod:`mxnet_tpu_torch.modelbus`), drain, :func:`live_servers` /
  :func:`live_stats`;
* :class:`HttpFrontEnd` (``http.py``, imported when first used): JSON over
  HTTP;
* :func:`configure` and the ``MXNET_TPU_SERVING`` grammar
  (``config.py``).

::

    from mxnet_tpu_torch import serving

    c = serving.ModelContainer()
    c.add_block("clf", net, example_shape=(128,))   # weights to the card
    server = serving.ModelServer(c, cache=True).start()
    server.warmup()                       # every bucket captured
    server.watch_bus("/path/to/bus")      # live weight updates
    y = server.predict("clf", x, priority="batch", deadline_ms=50)
    server.drain()                        # answer admitted, stop

Not ported, raising :class:`~mxnet_tpu_torch.base.MXNetError`: the serving
fleet (``ServingFleet``, ``FleetError``: worker processes behind a
router), ``ModelServer.run_until_drained`` (the preemption handlers) and
``ServedModel.from_onnx`` (the ONNX importer). A batch runs without the
watchdog's deadline, and responses carry no traced phases.
"""
from .batcher import PRIORITIES, BucketBatcher, ServingFuture
from .cache import PredictionCache, content_key
from .config import (DEFAULTS, configure, configure_from_env, describe,
                     effective)
from .errors import (DeadlineExceeded, ModelNotFound, RequestError,
                     RequestTimeout, ServerBusyError, ServerDrainingError,
                     ServingError)
from .metrics import ModelMetrics
from .model import ModelContainer, ServedModel
from .server import ModelServer, live_servers, live_stats

__all__ = [
    "configure", "configure_from_env", "describe", "effective", "DEFAULTS",
    "ServingError", "ModelNotFound", "ServerBusyError",
    "ServerDrainingError", "RequestError", "RequestTimeout",
    "DeadlineExceeded", "ModelMetrics", "ModelContainer", "ServedModel",
    "PredictionCache", "content_key", "BucketBatcher", "ServingFuture",
    "PRIORITIES", "ModelServer", "live_servers", "live_stats",
    "HttpFrontEnd",
]


def __getattr__(name):
    if name == "HttpFrontEnd":  # http.server pulled in only when used
        from .http import HttpFrontEnd

        return HttpFrontEnd
    if name in ("ServingFleet", "FleetError"):
        from ..base import MXNetError

        raise MXNetError(f"serving.{name} is not ported: the serving fleet "
                         "(worker processes behind a router) is not in "
                         "mxnet_tpu_torch")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
