"""ModelServer: the front door over a ModelContainer.

Counterpart of ``mxnet_tpu/serving/server.py``: one
:class:`~mxnet_tpu_torch.serving.batcher.BucketBatcher` per model (one
model's queue never blocks another's), submit/predict routing, aggregate
``stats()``, and the drain protocol (stop admission, answer everything
admitted, stop the threads). The model bus and preemption hooks are not
ported yet.
"""
from __future__ import annotations

import threading
import time

from .batcher import BucketBatcher
from .errors import ModelNotFound

__all__ = ["ModelServer"]


class ModelServer:
    """Serve every model in a :class:`ModelContainer` with continuous
    batching and admission control."""

    def __init__(self, container, max_queue=None, max_wait_ms=None,
                 name="mxtt-server"):
        self.name = name
        self._container = container
        self._overrides = {"max_queue": max_queue,
                           "max_wait_ms": max_wait_ms}
        self._batchers = {}
        self._started = False
        self._draining = False
        self._t_start = None
        self._drain_event = None
        self._lock = threading.Lock()

    def start(self):
        with self._lock:
            if self._started:
                return self
            for model in self._container:
                self._batchers[model.name] = BucketBatcher(
                    model, **self._overrides).start()
            self._started = True
            self._t_start = time.monotonic()
        return self

    def warmup(self):
        """Run every model's bucket ladder once through its runner
        thread before traffic (see ``BucketBatcher.warmup``)."""
        if not self._started:
            raise RuntimeError(f"server {self.name!r} not started")
        return {"models": {name: b.warmup()
                           for name, b in self._batchers.items()}}

    @property
    def started(self):
        return self._started

    @property
    def draining(self):
        return self._draining

    @property
    def container(self):
        return self._container

    def models(self):
        return list(self._batchers) if self._batchers \
            else self._container.names()

    def model_info(self):
        """Per-model metadata: input dtype, weight dtype (``"int8"`` for
        quantized models), bucket ladder, example shape, and the
        bucket graphs captured so far with their host milliseconds."""
        return {m.name: {"dtype": m.dtype,
                         "weight_dtype": m.weight_dtype,
                         "quantized": m.quantized,
                         "buckets": list(m.buckets),
                         "example_shape": list(m.example_shape),
                         **_captures(m)}
                for m in self._container}

    def _batcher(self, model):
        b = self._batchers.get(model)
        if b is None:
            if not self._started:
                raise RuntimeError(f"server {self.name!r} not started")
            raise ModelNotFound(f"model {model!r} not served; available: "
                                f"{sorted(self._batchers)}")
        return b

    def submit(self, model, arr):
        """Admit one request; returns a ServingFuture. Fast-rejects with
        ServerBusyError / ServerDrainingError."""
        return self._batcher(model).submit(arr)

    def predict(self, model, arr, timeout=None):
        """Synchronous submit and bounded wait."""
        return self.submit(model, arr).result(timeout)

    def drain(self, timeout=30.0):
        """Stop admission on every model, answer everything admitted,
        stop the threads. True when fully drained in time."""
        self._draining = True
        ok = True
        for b in self._batchers.values():
            ok = b.drain(timeout=timeout) and ok
        for b in self._batchers.values():
            b.stop()
        self._drain_event = {
            "time": time.time(), "drained": ok,
            "answered": sum(b.metrics.completed
                            for b in self._batchers.values()),
            "failed": sum(b.metrics.failed for b in self._batchers.values())}
        return ok

    def stop(self):
        """Hard stop: queued requests fail. After drain() it only joins."""
        for b in self._batchers.values():
            b.stop()
        self._started = False

    def stats(self):
        """Per-model counters, latency percentiles, queue depth, bucket
        census and fill ratio, input and weight dtype, plus the last
        drain."""
        models = {name: b.metrics.snapshot(
            queue_depth=b.queue_depth(), buckets=list(b.model.buckets),
            dtype=b.model.dtype, weight_dtype=b.model.weight_dtype,
            device=str(b.model.device),
            draining=b.draining, **_captures(b.model))
            for name, b in self._batchers.items()}
        return {"name": self.name, "started": self._started,
                "draining": self._draining,
                "uptime_s": time.monotonic() - self._t_start
                if self._t_start else None,
                "models": models, "last_drain": self._drain_event}

    def __repr__(self):
        return (f"ModelServer({self.name!r}, models={self.models()}, "
                f"started={self._started})")


def _captures(model):
    """A model's bucket graphs: how many were captured (CUDA graphs; 0 on
    the CPU, where buckets run plainly), their host milliseconds in all
    and by bucket, and the replays so far."""
    st = model.capture_stats()
    return {"captures": st["captures"], "capture_ms": st["capture_ms"],
            "capture_ms_by_bucket": st["capture_ms_by_bucket"]
            if st["captures"] else {},
            "replays": st["replays"]}
