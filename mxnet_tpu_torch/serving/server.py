"""ModelServer: the front door over a ModelContainer.

Counterpart of ``mxnet_tpu/serving/server.py``: one
:class:`~mxnet_tpu_torch.serving.batcher.BucketBatcher` per model (one
model's queue never blocks another's), submit/predict routing with a
priority class and a deadline, aggregate ``stats()``, the subscription to
a model bus (:meth:`ModelServer.watch_bus`: live weight updates between
batches), and the drain protocol (stop the bus watcher, stop admission,
answer everything admitted, stop the threads).

Live servers register in a weak set (:func:`live_servers`,
:func:`live_stats`). ``run_until_drained`` raises
:class:`~mxnet_tpu_torch.base.MXNetError`: the preemption handlers it
waits on are not ported.
"""
from __future__ import annotations

import threading
import time
import weakref

from ..base import MXNetError
from .batcher import BucketBatcher
from .errors import ModelNotFound

__all__ = ["ModelServer", "live_servers", "live_stats"]

_LIVE = weakref.WeakSet()


def live_servers():
    """ModelServer instances alive in this process."""
    return list(_LIVE)


def live_stats():
    """stats() of every live server."""
    return [s.stats() for s in live_servers()]


class ModelServer:
    """Serve every model in a :class:`ModelContainer` with continuous
    batching, admission control, priority classes and deadlines."""

    def __init__(self, container, max_queue=None, max_wait_ms=None,
                 stage=None, cache=None, cache_entries=None,
                 name="mxtt-server"):
        self.name = name
        self._container = container
        self._overrides = {"max_queue": max_queue,
                           "max_wait_ms": max_wait_ms, "stage": stage,
                           "cache": cache, "cache_entries": cache_entries}
        self._batchers = {}
        self._started = False
        self._draining = False
        self._t_start = None
        self._drain_event = None
        self._bus_watcher = None
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
        _LIVE.add(self)
        return self

    def warmup(self):
        """Run every model's bucket ladder once through its runner
        thread before traffic (see ``BucketBatcher.warmup``)."""
        if not self._started:
            raise RuntimeError(f"server {self.name!r} not started")
        return {"models": {name: b.warmup()
                           for name, b in self._batchers.items()}}

    def watch_bus(self, bus, poll=0.25, worker=None):
        """Subscribe this server to a model bus (a directory path or a
        :class:`~mxnet_tpu_torch.modelbus.ModelBus`): a background
        watcher validates each new version (CRC, shape/dtype census,
        finiteness) and flips every census-matching served model between
        batches, with nothing captured again. Returns the
        :class:`~mxnet_tpu_torch.modelbus.BusWatcher`."""
        from ..modelbus import BusWatcher

        with self._lock:
            if self._bus_watcher is None:
                self._bus_watcher = BusWatcher(
                    self, bus, poll=poll,
                    worker=worker or self.name).start()
        return self._bus_watcher

    @property
    def bus_watcher(self):
        """The active bus watcher, or None (not subscribed)."""
        return self._bus_watcher

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

    def submit(self, model, arr, priority="interactive", deadline_ms=None):
        """Admit one request; returns a ServingFuture. Fast-rejects with
        ServerBusyError / ServerDrainingError / DeadlineExceeded.
        ``priority``: the QoS class (interactive | batch); ``deadline_ms``
        drops the request before it takes a batch slot when it provably
        cannot be met."""
        return self._batcher(model).submit(arr, priority=priority,
                                           deadline_ms=deadline_ms)

    def predict(self, model, arr, timeout=None, priority="interactive",
                deadline_ms=None):
        """Synchronous submit and bounded wait."""
        return self.submit(model, arr, priority=priority,
                           deadline_ms=deadline_ms).result(timeout)

    def drain(self, timeout=30.0):
        """Stop the bus watcher (no flip mid-drain), stop admission on
        every model, answer everything admitted, stop the threads. True
        when fully drained in time."""
        self._draining = True
        if self._bus_watcher is not None:
            self._bus_watcher.stop()
        ok = True
        for b in self._batchers.values():
            ok = b.drain(timeout=timeout) and ok
        answered = sum(b.metrics.completed for b in self._batchers.values())
        failed = sum(b.metrics.failed for b in self._batchers.values())
        for b in self._batchers.values():
            b.stop()
        self._drain_event = {"time": time.time(), "drained": ok,
                             "answered": answered, "failed": failed}
        return ok

    def stop(self):
        """Hard stop: queued requests fail. After drain() it only joins."""
        if self._bus_watcher is not None:
            self._bus_watcher.stop()
        for b in self._batchers.values():
            b.stop()
        self._started = False
        _LIVE.discard(self)

    def run_until_drained(self, poll=0.05, install=True, exit=False):
        """Not ported: it waits for a preemption request from the
        preemption handlers, which mxnet_tpu_torch does not have. Call
        :meth:`drain` instead."""
        raise MXNetError("ModelServer.run_until_drained is not ported: the "
                         "preemption handlers it waits on are not in "
                         "mxnet_tpu_torch; call drain()")

    def stats(self):
        """Per-model counters, latency percentiles (overall and by
        class), queue depth, bucket census and fill ratio, input and
        weight dtype, the served version and swap count, the prediction
        cache, the bus watcher's state and the last drain."""
        models = {name: b.metrics.snapshot(
            queue_depth=b.queue_depth(), buckets=list(b.model.buckets),
            dtype=b.model.dtype, weight_dtype=b.model.weight_dtype,
            model_version=b.model.version, weight_swaps=b.model.swaps,
            device=str(b.model.device), draining=b.draining,
            cache=b.cache.stats() if b.cache is not None else None,
            **_captures(b.model))
            for name, b in self._batchers.items()}
        return {"name": self.name, "started": self._started,
                "draining": self._draining,
                "uptime_s": time.monotonic() - self._t_start
                if self._t_start else None,
                "models": models,
                "model_bus": self._bus_watcher.stats()
                if self._bus_watcher is not None else None,
                "last_drain": self._drain_event}

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
