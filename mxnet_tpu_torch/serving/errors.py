"""Serving error types (counterpart of ``mxnet_tpu/serving/errors.py``).

Admission rejects are fast (raised at ``submit``, never after
queueing), execution failures carry their cause, and every client wait
is bounded (:class:`RequestTimeout`). The HTTP front end maps them to
404 (ModelNotFound), 429 (ServerBusyError), 503 (ServerDrainingError),
504 (RequestTimeout, and DeadlineExceeded with ``"dropped": true``) and
500 (RequestError).
"""
from __future__ import annotations

__all__ = ["ServingError", "ModelNotFound", "ServerBusyError",
           "ServerDrainingError", "RequestError", "RequestTimeout",
           "DeadlineExceeded"]


class ServingError(RuntimeError):
    """Base class for every serving-layer error."""


class ModelNotFound(ServingError):
    """The named model is not in the served container."""


class ServerBusyError(ServingError):
    """The model's queue-depth bound is full (HTTP 429 analogue), raised
    at submit time. Attributes: ``model``, ``depth`` (rows waiting),
    ``limit``."""

    def __init__(self, model, depth, limit):
        self.model = model
        self.depth = depth
        self.limit = limit
        super().__init__(
            f"model {model!r} queue is full ({depth}/{limit} rows waiting)"
            " — retry with backoff (HTTP 429 analogue)")


class ServerDrainingError(ServerBusyError):
    """Admission stopped because the server is draining or stopped
    (HTTP 503 analogue); what was admitted before still completes."""

    def __init__(self, model, reason="draining"):
        self.model = model
        self.depth = 0
        self.limit = 0
        ServingError.__init__(
            self, f"model {model!r} not admitting requests ({reason}) — "
            "the server is shutting down; retry against another replica")


class RequestError(ServingError):
    """The batch this request was coalesced into failed; the underlying
    exception is ``cause`` (and ``__cause__``)."""

    def __init__(self, message, cause=None):
        self.cause = cause
        super().__init__(message)
        if cause is not None:
            self.__cause__ = cause


class RequestTimeout(ServingError):
    """``ServingFuture.result()`` waited longer than its timeout."""


class DeadlineExceeded(ServingError):
    """The request's own deadline cannot be met, so it was dropped before
    it took a batch slot (HTTP 504 analogue; no compute was spent on it).
    Raised at submit time when the measured batch time already overshoots
    the deadline, or by the collector when the deadline expired (or the
    estimate overshoots) while the request waited. Attributes: ``model``,
    ``deadline_ms``, ``estimate_ms`` (the batcher's estimate, when known),
    ``where`` (``"submit"`` | ``"queue"``)."""

    def __init__(self, model, deadline_ms, estimate_ms=None, where="queue"):
        self.model = model
        self.deadline_ms = deadline_ms
        self.estimate_ms = estimate_ms
        self.where = where
        est = (f"; estimated completion {estimate_ms:.1f}ms"
               if estimate_ms is not None else "")
        super().__init__(
            f"model {model!r} request dropped at {where}: cannot meet "
            f"{deadline_ms:.1f}ms deadline{est} (HTTP 504 analogue, "
            "no batch slot was consumed)")
