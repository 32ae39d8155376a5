"""Continuous batching: per-model request queue -> padded buckets.

Counterpart of ``mxnet_tpu/serving/batcher.py`` (the collect / pad / run
/ fulfil loop, :393-570). One :class:`BucketBatcher` per served model,
two daemon threads:

* the **collector** pops waiting requests and coalesces them into the
  nearest bucket under the ``max_wait_ms`` window (a full bucket goes at
  once), pads them into a pinned host batch, and starts its copy to the
  card on a side stream (``ServedModel.stage``), so the copy of batch
  N+1 overlaps the compute of batch N;
* the **runner** waits for the copy on its own stream, runs the batch,
  slices the outputs back per request and fulfils the futures.

On a card the runner replays the bucket's CUDA graph
(``ServedModel.run``); a bucket first met under traffic is captured
there, on the runner thread, while the collector goes on staging. The
collector stages into a fresh pinned host batch and a fresh device
tensor, never into a graph's static input: the replay copies the staged
tensor in on the runner's stream, after its ``ready`` event and after
the previous replay's copies. Captures run in ``thread_local`` error
mode under one process-wide lock (``compile.py``), so the runners of two
models may capture and replay at once.

Admission control: ``submit`` fast-rejects with
:class:`~mxnet_tpu_torch.serving.errors.ServerBusyError` once the
queued rows reach ``max_queue`` and with ``ServerDrainingError`` once a
drain or stop began. Every wait carries a timeout.
"""
from __future__ import annotations

import queue as _qmod
import threading
import time
from collections import deque

import torch

from .config import DEFAULTS, coerce
from .errors import (RequestError, RequestTimeout, ServerBusyError,
                     ServerDrainingError)
from .metrics import ModelMetrics

__all__ = ["ServingFuture", "BucketBatcher"]


class ServingFuture:
    """Client handle for one request. ``result`` is always bounded: with
    no timeout given, the default ``timeout_ms`` applies."""

    __slots__ = ("model", "t_submit", "t_done", "_event", "_result",
                 "_error")

    def __init__(self, model):
        self.model = model
        self.t_submit = time.monotonic()
        self.t_done = None
        self._event = threading.Event()
        self._result = None
        self._error = None

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """The response (one numpy array, or a list for multi-output
        models), or raises the request's failure; raises
        :class:`RequestTimeout` after ``timeout`` seconds."""
        if timeout is None:
            timeout = DEFAULTS["timeout_ms"] / 1e3
        if not self._event.wait(timeout):
            raise RequestTimeout(f"request to {self.model!r} not answered "
                                 f"within {timeout:g}s")
        if self._error is not None:
            raise self._error
        return self._result

    def latency_ms(self):
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1e3

    def _fulfill(self, result):
        self.t_done = time.monotonic()
        self._result = result
        self._event.set()

    def _fail(self, error):
        self.t_done = time.monotonic()
        self._error = error
        self._event.set()


class _Request:
    __slots__ = ("arr", "n", "fut")

    def __init__(self, arr, n, fut):
        self.arr = arr
        self.n = n
        self.fut = fut


class BucketBatcher:
    """The per-model queue and its collector/runner thread pair."""

    def __init__(self, model, metrics=None, max_queue=None,
                 max_wait_ms=None):
        self.model = model
        self.metrics = metrics or ModelMetrics(model.name)
        self._max_queue = coerce("max_queue", DEFAULTS["max_queue"]
                                 if max_queue is None else max_queue)
        self._max_wait = coerce("max_wait_ms", DEFAULTS["max_wait_ms"]
                                if max_wait_ms is None else max_wait_ms) / 1e3
        self._q = deque()
        self._rows = 0           # rows waiting (the admission bound)
        self._inflight = 0       # batches popped but not yet finished
        self._cond = threading.Condition()
        self._staged = _qmod.Queue(maxsize=1)
        self._draining = False
        self._stopping = False
        self._threads = ()

    def start(self):
        if self._threads:
            return self
        self._collector = threading.Thread(
            target=self._collect_loop, daemon=True,
            name=f"mxtt-serve-{self.model.name}-collect")
        self._runner = threading.Thread(
            target=self._run_loop, daemon=True,
            name=f"mxtt-serve-{self.model.name}-run")
        self._threads = (self._collector, self._runner)
        self._collector.start()
        self._runner.start()
        return self

    def queue_depth(self):
        """Rows waiting for a batch."""
        return self._rows

    @property
    def draining(self):
        return self._draining

    def drain(self, timeout=30.0):
        """Stop admission and answer everything already admitted (queued
        and in flight). True when fully drained within ``timeout``."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            with self._cond:
                if not self._q and self._inflight == 0:
                    return True
            time.sleep(0.005)
        return False

    def stop(self, timeout=5.0):
        """Stop the threads; requests still queued fail with
        ServerDrainingError (call :meth:`drain` first to answer them)."""
        with self._cond:
            self._stopping = True
            self._draining = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)
        self._threads = ()
        with self._cond:
            leftovers = list(self._q)
            self._q.clear()
            self._rows = 0
        for r in leftovers:
            r.fut._fail(ServerDrainingError(self.model.name, "stopped"))
        self.metrics.record_fail(len(leftovers))

    def warmup(self, timeout=300.0):
        """Run one zero batch per bucket through the runner thread before
        traffic: on a card this captures every bucket's graph there, and
        the first requests find its cuBLAS handle, the copy stream and
        the memory pools ready (PyTorch keeps cuBLAS handles per
        thread). Needs :meth:`start`; returns the ladder and the
        milliseconds it took."""
        if not self._threads:
            raise RuntimeError(f"batcher for {self.model.name!r} not started")
        t0 = time.perf_counter()
        for b in self.model.buckets:
            x, ready = self.model.stage(self.model.host_batch(b))
            done = ServingFuture(self.model.name)
            self._staged.put(([], x, ready, 0, b, done), timeout=timeout)
            done.result(timeout)
        return {"buckets": list(self.model.buckets),
                "ms": (time.perf_counter() - t0) * 1e3}

    def submit(self, arr):
        """Admit one request and return its :class:`ServingFuture`, or
        fast-reject on a full queue or a draining server."""
        arr = self.model.validate(arr)
        n = arr.shape[0]
        fut = ServingFuture(self.model.name)
        with self._cond:
            if self._draining or self._stopping:
                self.metrics.record_reject()
                raise ServerDrainingError(self.model.name)
            if self._rows + n > self._max_queue:
                self.metrics.record_reject()
                raise ServerBusyError(self.model.name, self._rows,
                                      self._max_queue)
            self._q.append(_Request(arr, n, fut))
            self._rows += n
            self._cond.notify_all()
        self.metrics.record_submit()
        return fut

    def _collect(self):
        """Pop one coalesced batch ``(requests, rows)`` once the bucket
        is full or the oldest request waited ``max_wait_ms``; None when
        stopping."""
        with self._cond:
            while not self._q:
                if self._stopping:
                    return None
                self._cond.wait(timeout=0.1)
            cap = self.model.max_bucket
            deadline = self._q[0].fut.t_submit + self._max_wait
            while (self._q and self._rows < cap and not self._stopping
                   and not self._draining):
                now = time.monotonic()
                if now >= deadline:
                    break
                self._cond.wait(timeout=min(deadline - now, 0.05))
            reqs, rows = [], 0
            while self._q and rows + self._q[0].n <= cap:
                r = self._q.popleft()
                self._rows -= r.n
                reqs.append(r)
                rows += r.n
            if not reqs:  # stop() emptied the queue while we waited
                return None
            self._inflight += 1
            return reqs, rows

    def _assemble(self, reqs, bucket):
        host = self.model.host_batch(bucket)
        off = 0
        for r in reqs:
            host[off:off + r.n] = torch.from_numpy(r.arr)
            off += r.n
        return host

    def _collect_loop(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            reqs, rows = batch
            bucket = self.model.bucket_for(rows)
            try:
                x, ready = self.model.stage(self._assemble(reqs, bucket))
            except Exception as e:  # fail this batch, keep serving
                self._fail_batch(reqs, RequestError(
                    f"model {self.model.name!r}: staging {rows} rows "
                    f"failed: {type(e).__name__}: {e}", cause=e))
                continue
            while True:
                try:
                    self._staged.put((reqs, x, ready, rows, bucket, None),
                                     timeout=0.25)
                    break
                except _qmod.Full:
                    if self._stopping:
                        self._fail_batch(reqs, ServerDrainingError(
                            self.model.name, "stopped"))
                        return

    def _fail_batch(self, reqs, err):
        for r in reqs:
            r.fut._fail(err)
        self.metrics.record_fail(len(reqs))
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    def _run_loop(self):
        model = self.model
        while True:
            try:
                reqs, x, ready, rows, bucket, warm = self._staged.get(
                    timeout=0.25)
            except _qmod.Empty:
                if self._stopping and not self._collector.is_alive():
                    return
                continue
            try:
                outs = model.run(x, rows, ready)
            except Exception as e:  # fail this batch, keep serving
                err = RequestError(
                    f"model {model.name!r}: batch of {rows} rows failed: "
                    f"{type(e).__name__}: {e}", cause=e)
                if warm is not None:
                    warm._fail(err)
                else:
                    self._fail_batch(reqs, err)
                continue
            if warm is not None:
                warm._fulfill(None)
                continue
            now = time.monotonic()
            off = 0
            for r in reqs:
                sliced = [o[off:off + r.n] for o in outs]
                r.fut._fulfill(sliced[0] if len(sliced) == 1 else sliced)
                self.metrics.record_complete((now - r.fut.t_submit) * 1e3)
                off += r.n
            self.metrics.record_batch(bucket, rows)
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()
