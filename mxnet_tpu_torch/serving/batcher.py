"""Continuous batching: per-model request queues -> padded buckets.

Counterpart of ``mxnet_tpu/serving/batcher.py``. One :class:`BucketBatcher`
per served model, two daemon threads:

* the **collector** pops waiting requests and coalesces them into the
  nearest bucket under the ``max_wait_ms`` window (a full bucket goes at
  once), pads them into a pinned host batch, and starts its copy to the
  card on a side stream (``ServedModel.stage``; ``stage:0`` leaves the
  copy to the runner), so the copy of batch N+1 overlaps the compute of
  batch N;
* the **runner** runs each batch (``ServedModel.run_versioned``, with the
  ``serving.batch`` fault-injection point before it), slices the outputs
  back per request and fulfils the futures, stamping each with the
  version of the weights the batch ran on.

On a card the runner replays the bucket's CUDA graph on the model's
replay stream; a bucket first met under traffic is captured there, on
the runner thread, while the collector goes on staging. The collector
stages into a fresh pinned host batch and a fresh device tensor, never
into a graph's static input: the replay copies the staged tensor in on
the replay stream, after its ``ready`` event and after the previous
replay's copies. Captures run in ``thread_local`` error mode under one
process-wide lock (``compile.py``), so the runners of two models may
capture and replay at once.

Admission control: ``submit`` fast-rejects with
:class:`~mxnet_tpu_torch.serving.errors.ServerBusyError` once the queued
rows reach ``max_queue`` and with ``ServerDrainingError`` once a drain or
stop began.

QoS and deadlines: a request carries a priority class (``interactive`` /
``batch``) and an optional deadline. The collector drains interactive
requests first and lets batch requests fill the bucket's leftover rows,
so under overload the batch class starves before interactive latency
grows; admission likewise counts batch rows against the whole queue and
interactive rows against the interactive queue alone. A request that
provably cannot meet its deadline is dropped with
:class:`DeadlineExceeded` before it takes a batch slot: at submit when
the measured batch time (an EWMA) already overshoots it, and at pop time
when it expired or the estimate overshoots what is left.

Prediction cache: with ``cache:1`` a
:class:`~mxnet_tpu_torch.serving.cache.PredictionCache` sits in front of
admission; a hit is answered on the submit thread, and a request equal
to one already queued or running rides on it as a follower. An answer
is inserted only under the version its batch ran on, so a live weight
swap never serves a stale answer.

Tracing: with :mod:`mxnet_tpu_torch.telemetry.trace` on, every request
carries a :class:`~mxnet_tpu_torch.telemetry.trace.RequestTrace` with
the id the HTTP front end bound to the submitting thread (or a fresh
one); the collector marks ``collected`` when it pops the batch,
``assembled`` when the rows are in the pinned host batch and ``staged``
when its copy to the card is started, the runner ``run_begin`` and
``run_end`` around the bucket's run, and fulfilment closes the five
phases (``ServingFuture.request_id``, ``breakdown()``).

Not ported: the watchdog deadline around a batch (a batch runs without
one, as the JAX package's does with no watchdog configured). Every wait
carries a timeout.
"""
from __future__ import annotations

import queue as _qmod
import threading
import time
from collections import deque

import torch

from .. import faults as _faults
from ..telemetry import trace as _trace
from . import cache as _pcache
from . import config as _config
from .errors import (DeadlineExceeded, RequestError, RequestTimeout,
                     ServerBusyError, ServerDrainingError)
from .metrics import ModelMetrics

__all__ = ["ServingFuture", "BucketBatcher", "PRIORITIES"]

PRIORITIES = ("interactive", "batch")


class ServingFuture:
    """Client handle for one request. ``result`` is always bounded: with
    no timeout given, the configured ``timeout_ms`` applies."""

    __slots__ = ("model", "t_submit", "t_done", "_event", "_result",
                 "_error", "_trace", "model_version", "priority",
                 "deadline_ms", "cache_hit")

    def __init__(self, model, priority="interactive", deadline_ms=None):
        self.model = model
        self.t_submit = time.monotonic()
        self.t_done = None
        self._event = threading.Event()
        self._result = None
        self._error = None
        self._trace = None   # the RequestTrace, with tracing on
        # the version of the weights the answering batch ran on (stamped
        # at fulfilment; None until then and on failure)
        self.model_version = None
        self.priority = priority
        self.deadline_ms = deadline_ms
        self.cache_hit = False   # answered from the prediction cache

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """The response (one numpy array, or a list for multi-output
        models), or raises the request's failure; raises
        :class:`RequestTimeout` after ``timeout`` seconds."""
        if timeout is None:
            timeout = _config.effective()["timeout_ms"] / 1e3
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

    @property
    def request_id(self):
        """The propagated request id (None with tracing off)."""
        return self._trace.request_id if self._trace is not None else None

    def breakdown(self):
        """The five-phase breakdown of an answered request
        (``queue_wait_ms`` ... ``respond_ms``, ``total_ms``), or None
        (tracing off, or not answered yet)."""
        return self._trace.breakdown if self._trace is not None else None

    def _finish(self, **kw):
        """Close the request's trace; called before the future is
        answered, so a caller woken by the answer finds its breakdown."""
        if self._trace is not None:
            self._trace.finish(**kw)

    def _fulfill(self, result):
        self.t_done = time.monotonic()
        self._result = result
        self._event.set()

    def _fail(self, error):
        self.t_done = time.monotonic()
        self._error = error
        self._event.set()


class _Request:
    __slots__ = ("arr", "n", "fut", "deadline", "key", "key_version",
                 "followers")

    def __init__(self, arr, n, fut, deadline=None, key=None,
                 key_version=None):
        self.arr = arr
        self.n = n
        self.fut = fut
        self.deadline = deadline        # absolute monotonic, or None
        self.key = key                  # prediction-cache content key
        self.key_version = key_version  # served version the key names
        self.followers = []             # equal requests riding this one


class BucketBatcher:
    """The per-model queues and their collector/runner thread pair."""

    def __init__(self, model, metrics=None, max_queue=None,
                 max_wait_ms=None, stage=None, cache=None,
                 cache_entries=None):
        cfg = _config.effective()
        self.model = model
        self.metrics = metrics or ModelMetrics(model.name)
        self._max_queue = _config.coerce(
            "max_queue", cfg["max_queue"] if max_queue is None else max_queue)
        self._max_wait = _config.coerce(
            "max_wait_ms", cfg["max_wait_ms"] if max_wait_ms is None
            else max_wait_ms) / 1e3
        self._stage = cfg["stage"] if stage is None else bool(stage)
        self._qi = deque()       # interactive: always drained first
        self._qb = deque()       # batch: fills leftover bucket rows
        self._rows = 0           # total rows waiting (the batch bound)
        self._rows_i = 0         # interactive rows waiting (its own bound)
        self._inflight = 0       # batches popped but not yet finished
        self._cond = threading.Condition()
        self._leaders = {}       # content key -> queued/running _Request
        self._est_ms = None      # EWMA of a batch's run time
        use_cache = cfg["cache"] if cache is None else bool(cache)
        self.cache = _pcache.PredictionCache(
            cfg["cache_entries"] if cache_entries is None
            else cache_entries) if use_cache else None
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
        """Rows waiting for a batch (the bound admission checks)."""
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
                if not self._qi and not self._qb and self._inflight == 0:
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
            leftovers = list(self._qi) + list(self._qb)
            self._qi.clear()
            self._qb.clear()
            self._rows = 0
            self._rows_i = 0
            self._leaders.clear()
        for r in leftovers:
            err = ServerDrainingError(self.model.name, "stopped")
            for fut in (r.fut, *r.followers):
                fut._finish(error="ServerDrainingError")
                fut._fail(err)
                self.metrics.record_fail()

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
            x, ready = self._put(self.model.host_batch(b))
            done = ServingFuture(self.model.name)
            self._staged.put(([], x, ready, 0, b, done), timeout=timeout)
            done.result(timeout)
        return {"buckets": list(self.model.buckets),
                "ms": (time.perf_counter() - t0) * 1e3}

    def submit(self, arr, priority="interactive", deadline_ms=None):
        """Admit one request and return its :class:`ServingFuture`, or
        fast-reject on a full queue, a draining server or a deadline that
        provably cannot be met. ``priority`` picks the QoS class;
        ``deadline_ms`` bounds how late an answer is still useful."""
        arr = self.model.validate(arr)
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}: expected "
                             f"one of {PRIORITIES}")
        n = arr.shape[0]
        deadline_ms = None if deadline_ms is None else float(deadline_ms)
        fut = ServingFuture(self.model.name, priority=priority,
                            deadline_ms=deadline_ms)
        if _trace.enabled():
            # the HTTP front end binds X-Request-Id on this thread
            fut._trace = _trace.request_begin(self.model.name, rows=n)
        deadline = (fut.t_submit + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        key = key_version = None
        if self.cache is not None:
            key_version = self.model.version
            self.cache.observe_version(key_version)
            key = _pcache.content_key(self.model.name, key_version, arr)
            hit = self.cache.get(key)
            self.metrics.record_cache(hit is not None)
            if hit is not None:
                # answered here: no queue, no batch, no card
                self.metrics.record_submit()
                fut.cache_hit = True
                fut.model_version = key_version
                fut._finish()   # before the answer: a waiter reads it
                fut._fulfill(hit)
                self.metrics.record_complete(fut.latency_ms(), priority)
                if deadline_ms is not None:
                    self.metrics.record_deadline_outcome(True)
                return fut
        if deadline_ms is not None and self._est_ms is not None \
                and deadline_ms < self._est_ms:
            # even dispatched at once, the measured batch time alone
            # overshoots the deadline
            self.metrics.record_deadline_drop("submit")
            raise DeadlineExceeded(self.model.name, deadline_ms,
                                   self._est_ms, where="submit")
        with self._cond:
            if self._draining or self._stopping:
                self.metrics.record_reject()
                raise ServerDrainingError(self.model.name)
            if key is not None:
                leader = self._leaders.get(key)
                if leader is not None:
                    # an equal request is queued or running: ride on it
                    leader.followers.append(fut)
                    self.metrics.record_coalesced()
                    self.metrics.record_submit()
                    return fut
            bound_rows = self._rows_i if priority == "interactive" \
                else self._rows
            if bound_rows + n > self._max_queue:
                self.metrics.record_reject()
                raise ServerBusyError(self.model.name, bound_rows,
                                      self._max_queue)
            req = _Request(arr, n, fut, deadline=deadline, key=key,
                           key_version=key_version)
            if priority == "interactive":
                self._qi.append(req)
                self._rows_i += n
            else:
                self._qb.append(req)
            self._rows += n
            if key is not None:
                self._leaders[key] = req
            self._cond.notify_all()
        self.metrics.record_submit()
        return fut

    def _doomed(self, r, now):
        """Whether ``r`` provably cannot meet its deadline: it expired, or
        the batch-time estimate overshoots the time it has left."""
        if r.deadline is None:
            return False
        if now >= r.deadline:
            return True
        return (self._est_ms is not None
                and now + self._est_ms / 1e3 > r.deadline)

    def _drop_doomed_locked(self, r):
        """Fail a popped, doomed request and its followers with
        DeadlineExceeded; its rows were uncounted by the pop, so no batch
        slot is taken. ``_cond`` held."""
        if r.key is not None and self._leaders.get(r.key) is r:
            del self._leaders[r.key]
        err = DeadlineExceeded(self.model.name, r.fut.deadline_ms,
                               self._est_ms, where="queue")
        for fut in (r.fut, *r.followers):
            fut._finish(error="DeadlineExceeded")
            fut._fail(err)
            self.metrics.record_deadline_drop("queue")

    def _collect(self):
        """Pop one coalesced batch ``(requests, rows)`` once the bucket
        is full or the oldest request waited ``max_wait_ms``;
        interactive requests first, batch requests into the rows left.
        None when stopping."""
        with self._cond:
            while True:
                while not self._qi and not self._qb:
                    if self._stopping:
                        return None
                    self._cond.wait(timeout=0.1)
                cap = self.model.max_bucket
                head = self._qi[0] if self._qi else self._qb[0]
                deadline = head.fut.t_submit + self._max_wait
                while ((self._qi or self._qb) and self._rows < cap
                       and not self._stopping and not self._draining):
                    now = time.monotonic()
                    if now >= deadline:
                        break
                    self._cond.wait(timeout=min(deadline - now, 0.05))
                reqs, rows = [], 0
                now = time.monotonic()
                for q, interactive in ((self._qi, True), (self._qb, False)):
                    while q and rows + q[0].n <= cap:
                        r = q.popleft()
                        self._rows -= r.n
                        if interactive:
                            self._rows_i -= r.n
                        if self._doomed(r, now):
                            self._drop_doomed_locked(r)
                            continue
                        reqs.append(r)
                        rows += r.n
                if reqs:
                    break  # else every pop was doomed, or stop() emptied
                if self._stopping and not self._qi and not self._qb:
                    return None
            self._inflight += 1
            t_pop = time.monotonic()
            for r in reqs:   # queue_wait ends here for the whole batch
                if r.fut._trace is not None:
                    r.fut._trace.mark("collected", t_pop)
            return reqs, rows

    def _assemble(self, reqs, bucket):
        host = self.model.host_batch(bucket)
        off = 0
        for r in reqs:
            host[off:off + r.n] = torch.from_numpy(r.arr)
            off += r.n
        return host

    def _put(self, host):
        """``(batch, ready)``: the host batch's copy to the card started
        on the side stream, or the host batch itself with ``stage:0``."""
        return self.model.stage(host) if self._stage else (host, None)

    def _collect_loop(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            reqs, rows = batch
            bucket = self.model.bucket_for(rows)
            try:
                host = self._assemble(reqs, bucket)
                t_host = time.monotonic()
                x, ready = self._put(host)
                t_staged = time.monotonic()
                for r in reqs:   # batch_collect = assemble; h2d = stage
                    if r.fut._trace is not None:
                        r.fut._trace.mark("assembled", t_host)
                        r.fut._trace.mark("staged", t_staged)
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

    def _retire_leaders(self, reqs):
        """Unregister the requests' content keys before fulfilment, so no
        follower attaches to a request whose followers are being
        answered (attaching takes the same lock)."""
        with self._cond:
            for r in reqs:
                if r.key is not None and self._leaders.get(r.key) is r:
                    del self._leaders[r.key]

    def _fail_batch(self, reqs, err):
        self._retire_leaders(reqs)
        n = 0
        for r in reqs:
            for fut in (r.fut, *r.followers):
                fut._finish(error=type(err).__name__)
                fut._fail(err)
                n += 1
        self.metrics.record_fail(n)
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
            t0 = time.monotonic()
            for r in reqs:
                if r.fut._trace is not None:
                    r.fut._trace.mark("run_begin", t0)
            try:
                if warm is None:
                    # 'serving.batch' injection: raise fails the batch,
                    # delay/hang stall it
                    _faults.point("serving.batch")
                outs, model_version = model.run_versioned(x, rows, ready)
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
            dur_ms = (now - t0) * 1e3
            # the estimate behind deadline admission
            self._est_ms = dur_ms if self._est_ms is None \
                else 0.8 * self._est_ms + 0.2 * dur_ms
            self._retire_leaders(reqs)
            off = 0
            for r in reqs:
                sliced = [o[off:off + r.n] for o in outs]
                value = sliced[0] if len(sliced) == 1 else sliced
                if r.fut._trace is not None:
                    r.fut._trace.mark("run_end", now)
                if self.cache is not None and r.key is not None \
                        and model_version == r.key_version:
                    # only under the version the key names: a flip while
                    # the request waited must not file an old answer
                    # under the new version
                    self.cache.put(r.key, value, model_version)
                for fut in (r.fut, *r.followers):
                    fut.model_version = model_version
                    fut._finish(bucket=bucket)
                    fut._fulfill(value)
                    lat = (now - fut.t_submit) * 1e3
                    self.metrics.record_complete(lat, fut.priority)
                    if fut.deadline_ms is not None:
                        self.metrics.record_deadline_outcome(
                            lat <= fut.deadline_ms)
                off += r.n
            self.metrics.record_batch(bucket, rows)
            with self._cond:
                self._inflight -= 1
                self._cond.notify_all()
