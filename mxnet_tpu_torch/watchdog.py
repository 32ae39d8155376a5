"""Watchdog: hang detection, deadline-bounded syncs, crash bundles.

Counterpart of ``mxnet_tpu/watchdog.py``: the same points, grammar,
escalation ladder and exit code. The points the port instruments:

    ``host.sync``      ``NDArray.wait_to_read`` / ``nd.waitall`` (a device
                       synchronise on a card)
    ``trainer.step``   the whole ``ShardedTrainer.step`` call
    ``io.fetch``       ``PrefetchingIter``'s join on its fetch threads
    ``kvstore.sync``   the dist kvstore's gloo waits (all-reduce,
                       all-gather, barrier); a deadline here raises
                       ``kvstore.PeerLostError`` naming the rank and the
                       wait
    ``kvstore.push`` / ``kvstore.pull``   liveness beats only
    ``serving.batch``  one served batch; a wedged batch fails its
                       requests typed and the server keeps serving

(``engine.flush``, the JAX package's bulk-segment barrier, has no
counterpart: the port has no engine bulking.)

Three pieces, as in the JAX package:

* **Heartbeats** -- :func:`beat` appends ``{t_mono, t_wall, point, label,
  thread}`` to a bounded ring; the last N ride in every crash bundle.
* **Monitor** -- a daemon thread scans the open spans and walks the
  ladder for any span past its deadline: a warning at ``warn`` x the
  deadline, then a **crash bundle** (``threads.txt``: every thread's
  traceback through ``faulthandler``; ``heartbeats.json``;
  ``report.json``: the span, the configuration, the open spans, the fault
  and profiler counters and, when no CUDA graph capture is open, the
  device memory; ``flight.json``: the flight recorder's tail), then the
  configured action.
* **Bounded syncs** -- :func:`sync` runs a blocking callable under a
  deadline. Under ``action:raise`` (the default) or ``action:abort`` the
  callable runs in a daemon *waiter* thread while the caller waits with a
  bound; at the deadline the caller writes the bundle (unless the monitor
  has) and raises :class:`StallError`, or runs the last-resort hook
  (:func:`set_last_resort`) and exits with :data:`ABORT_EXIT_CODE`.
  ``action:observe`` runs the callable inline; only the monitor escalates.

**Device waits.** Every bounded point, ``host.sync`` included, runs its
work in the waiter thread: a device wait there is
``torch.cuda.synchronize`` of the array's card, which releases the GIL,
so the caller's bounded ``Event.wait`` returns at the deadline while the
waiter stays blocked (a daemon: an abandoned waiter never holds up the
interpreter's exit). The other design, polling a recorded CUDA event
with ``query()`` in the caller, would wait for one stream only and could
not bound the host code around it (the ``host.sync`` fault point).

**The caller's state travels with the work.** A new thread starts with
torch's defaults and none of the port's thread-local state, so the waiter
runs under a snapshot taken in the caller (:func:`carried`): torch's grad
and inference modes, autocast (enabled, dtype and cache, per device type),
the current CUDA device and stream, and the port's thread-locals
(``autograd``'s recording and training flags, the ``Context`` stack,
np mode, ``AttrScope``, ``NameManager``, the gluon block scope and
parameter substitution, the compile service's nesting and capture
streams, the kernel launch record, the trace context and the host-op
watch stacks). Stacks are copied, so an abandoned waiter never pops the
caller's entries.

**CUDA calls outside the caller.** The monitor and the bundle writer make
no CUDA call while the port captures a CUDA graph
(``compile.capturing()``): the bundle then records no device memory. The
port captures with ``capture_error_mode="thread_local"``, and
``torch.cuda.is_current_stream_capturing`` would only see the monitor's
own stream.

Configuration: ``MXNET_TPU_WATCHDOG`` (read once, at first use) or
:func:`configure`. Grammar, entries separated by ``,`` or ``;``::

    <point>:<deadline-seconds>      per-point deadline (e.g. trainer.step:120)
    *:<deadline-seconds>            default deadline for every point
    action:<raise|abort|observe>    escalation terminal (default raise)
    warn:<fraction>                 warn at fraction x deadline (default 0.5)
    interval:<seconds>              monitor poll period (default: adaptive)
    dir:<path>                      crash-bundle directory (default
                                    $MXNET_TPU_CRASH_DIR or <tmp>/mxtpu_crash)
    beats:<N>                       heartbeat ring size (default 256)

Off by default: a point then costs one module-global check.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import sys
import tempfile
import threading
import time

from . import log as _log
from .telemetry import flight as _flight

__all__ = ["StallError", "configure", "configure_from_env", "enabled",
           "sync", "beat", "heartbeats", "set_last_resort", "last_resort",
           "crash_dir", "latest_bundle", "describe", "carried",
           "ABORT_EXIT_CODE"]

ABORT_EXIT_CODE = 86  # distinct from the interpreter's 1 and SIGKILL's 137

_logger = _log.get_logger("mxnet_tpu.watchdog")

_ACTIONS = ("raise", "abort", "observe")


class StallError(RuntimeError):
    """A bounded sync point exceeded its deadline.

    Attributes: ``point``, ``label``, ``elapsed``, ``deadline`` (seconds)
    and ``bundle`` (the crash-bundle directory, or None if writing it
    failed)."""

    def __init__(self, point, label, elapsed, deadline, bundle):
        self.point = point
        self.label = label
        self.elapsed = elapsed
        self.deadline = deadline
        self.bundle = bundle
        super().__init__(
            f"watchdog: {point!r}"
            + (f" ({label})" if label else "")
            + f" stalled for {elapsed:.1f}s (deadline {deadline:g}s)"
            + (f"; crash bundle: {bundle}" if bundle else ""))


class _Config:
    __slots__ = ("deadlines", "default", "action", "warn_fraction",
                 "interval", "crash_dir", "beats", "spec")

    def __init__(self):
        self.deadlines = {}     # point -> seconds
        self.default = None     # '*' entry: deadline for unlisted points
        self.action = "raise"
        self.warn_fraction = 0.5
        self.interval = None    # None = adaptive (min deadline / 4)
        self.crash_dir = None   # None = env/default resolution at write
        self.beats = 256
        self.spec = ""

    def deadline_for(self, point):
        d = self.deadlines.get(point)
        return self.default if d is None else d


class _Span:
    """One blocking region in flight, visible to the monitor."""

    __slots__ = ("point", "label", "start", "deadline", "thread",
                 "warned", "bundle", "bundled", "bundle_ready", "stalled")

    def __init__(self, point, label, deadline):
        self.point = point
        self.label = label
        self.start = time.monotonic()
        self.deadline = deadline
        self.thread = threading.current_thread().name
        self.warned = False
        self.bundle = None
        self.bundled = False                   # claimed by a writer
        self.bundle_ready = threading.Event()  # writer finished
        self.stalled = threading.Event()


_lock = threading.Lock()
_CFG: _Config | None = None
_loaded_env = False
_spans: dict = {}
_span_seq = 0
_bundle_seq = 0
_beats = None          # deque, sized by config
_monitor_gen = 0       # bumping it retires the running monitor thread
_monitor_stop = None   # set to wake the running monitor so it retires
_last_resort = None    # callable: final checkpoint attempt before abort
_exit_fn = os._exit    # test seam for the abort path


# ----------------------------------------------------------- configuration --

def _parse(spec):
    cfg = _Config()
    cfg.spec = spec
    for entry in re.split(r"[;,]", spec):
        entry = entry.strip()
        if not entry:
            continue
        key, sep, val = entry.partition(":")
        key, val = key.strip(), val.strip()
        if not sep or not val:
            raise ValueError(
                f"bad MXNET_TPU_WATCHDOG entry {entry!r}: expected "
                "<point>:<seconds> or <option>:<value>")
        if key == "action":
            if val not in _ACTIONS:
                raise ValueError(f"unknown watchdog action {val!r}; "
                                 f"expected one of {_ACTIONS}")
            cfg.action = val
        elif key == "warn":
            cfg.warn_fraction = float(val)
        elif key == "interval":
            cfg.interval = float(val)
        elif key == "dir":
            cfg.crash_dir = val
        elif key == "beats":
            cfg.beats = int(val)
        elif key == "*":
            cfg.default = float(val)
        else:
            cfg.deadlines[key] = float(val)
    if cfg.default is None and not cfg.deadlines:
        raise ValueError(
            f"MXNET_TPU_WATCHDOG spec {spec!r} configures no deadline; "
            "add '<point>:<seconds>' or '*:<seconds>' entries")
    return cfg


def configure(spec=None, **options):
    """Install a configuration (replacing any previous one and retiring
    its monitor thread).

    spec : str in the grammar above, dict ``{point: seconds}``, or None
        to turn the watchdog off.
    options : ``action=``, ``warn=``, ``interval=``, ``crash_dir=``,
        ``default=``, ``beats=`` applied on top.
    """
    global _CFG, _loaded_env, _beats, _monitor_gen, _monitor_stop
    if isinstance(spec, dict):
        spec = ",".join(f"{k}:{v}" for k, v in spec.items())
    cfg = _parse(spec) if spec else None
    if cfg is None and options:
        cfg = _Config()
        cfg.spec = "<programmatic>"
    if cfg is not None:
        for k, attr in (("action", "action"), ("warn", "warn_fraction"),
                        ("interval", "interval"), ("crash_dir", "crash_dir"),
                        ("default", "default"), ("beats", "beats")):
            if k in options:
                setattr(cfg, attr, options.pop(k))
        if options:
            raise TypeError(f"unknown watchdog options: {sorted(options)}")
        if cfg.action not in _ACTIONS:
            raise ValueError(f"unknown watchdog action {cfg.action!r}")
        if cfg.default is None and not cfg.deadlines:
            raise ValueError("watchdog configured with no deadline")
    from collections import deque

    with _lock:
        _loaded_env = True  # an explicit configure overrides the env
        _CFG = cfg
        _monitor_gen += 1
        if _monitor_stop is not None:
            _monitor_stop.set()   # the running monitor retires at once
        _monitor_stop = threading.Event()
        if cfg is not None:
            _beats = deque(_beats or (), maxlen=cfg.beats)
            _start_monitor(_monitor_gen, _monitor_stop)


def configure_from_env(force=True):
    """(Re-)read ``MXNET_TPU_WATCHDOG`` (tests restore the ambient
    configuration with it)."""
    global _loaded_env
    if force:
        _loaded_env = False
    _ensure_env()


def _ensure_env():
    global _loaded_env
    if _loaded_env:
        return
    with _lock:
        if _loaded_env:
            return
        _loaded_env = True
    env = os.environ.get("MXNET_TPU_WATCHDOG", "")
    if env:
        try:
            configure(env)
        except ValueError as e:
            _logger.warning("ignoring invalid MXNET_TPU_WATCHDOG: %s", e)
            configure(None)
    else:
        configure(None)


def enabled() -> bool:
    """True when a configuration with deadlines is installed."""
    _ensure_env()
    return _CFG is not None


def describe():
    """The effective configuration as a plain dict."""
    _ensure_env()
    cfg = _CFG
    if cfg is None:
        return {"enabled": False}
    return {"enabled": True, "spec": cfg.spec, "deadlines": dict(cfg.deadlines),
            "default_deadline": cfg.default, "action": cfg.action,
            "warn_fraction": cfg.warn_fraction, "interval": cfg.interval,
            "crash_dir": crash_dir(), "beats": cfg.beats}


def set_last_resort(fn):
    """Install the final-checkpoint hook that ``action:abort`` runs after
    the bundle and that ``preempt.drain`` runs by default;
    ``ShardedTrainer.save_checkpoint`` / ``resume`` register one. Returns
    the previous hook; None clears it."""
    global _last_resort
    prev, _last_resort = _last_resort, fn
    return prev


def last_resort():
    """The installed final-checkpoint hook, or None."""
    return _last_resort


# -------------------------------------------------------------- heartbeats --

def beat(point, label=None):
    """Report liveness at a named point (a no-op with the watchdog off).
    Thread-safe: ``deque.append`` is atomic."""
    if _CFG is None:
        return
    beats = _beats
    if beats is not None:
        beats.append({"t_mono": time.monotonic(), "t_wall": time.time(),
                      "point": point, "label": label,
                      "thread": threading.current_thread().name})


def heartbeats():
    """The last-N heartbeat records (newest last)."""
    beats = _beats
    return list(beats) if beats is not None else []


# ------------------------------------------------------------ crash bundle --

def crash_dir():
    """The effective crash-bundle directory (made when first needed)."""
    cfg = _CFG
    if cfg is not None and cfg.crash_dir:
        return cfg.crash_dir
    return os.environ.get("MXNET_TPU_CRASH_DIR") \
        or os.path.join(tempfile.gettempdir(), "mxtpu_crash")


def latest_bundle(directory=None):
    """The newest crash-bundle directory under ``directory`` (default: the
    effective crash dir), or None."""
    directory = directory or crash_dir()
    try:
        cands = [os.path.join(directory, n) for n in os.listdir(directory)
                 if n.startswith("bundle-")]
    except OSError:
        return None
    cands = [c for c in cands if os.path.isdir(c)]
    return max(cands, key=os.path.getmtime) if cands else None


def _active_spans_snapshot():
    now = time.monotonic()
    with _lock:
        spans = list(_spans.values())
    return [{"point": s.point, "label": s.label, "thread": s.thread,
             "elapsed_s": round(now - s.start, 3), "deadline_s": s.deadline}
            for s in spans]


def _write_bundle(span):
    """Write one crash bundle for ``span``; the first writer (monitor or
    bounded caller) wins and the other waits for its path. Returns the
    bundle directory, or None when writing failed."""
    global _bundle_seq
    with _lock:
        if span.bundled:
            claimed = False
        else:
            span.bundled = True
            claimed = True
            _bundle_seq += 1
            seq = _bundle_seq
    if not claimed:
        span.bundle_ready.wait(timeout=15)
        return span.bundle
    try:
        root = crash_dir()
        stamp = time.strftime("%Y%m%d-%H%M%S")
        name = f"bundle-{stamp}-p{os.getpid()}-{seq}-" \
               + span.point.replace(".", "_")
        path = os.path.join(root, name)
        os.makedirs(path, exist_ok=True)
        _dump_tracebacks(os.path.join(path, "threads.txt"))
        with open(os.path.join(path, "heartbeats.json"), "w") as f:
            json.dump(heartbeats(), f, indent=1)
        with open(os.path.join(path, "report.json"), "w") as f:
            json.dump(_report(span), f, indent=1, default=repr)
        _flight.rec("watchdog.stall", span.point, span.label)
        with open(os.path.join(path, "flight.json"), "w") as f:
            json.dump(_flight.tail(), f, indent=1, default=repr)
        span.bundle = path
        _logger.error("watchdog: %r (%s) stalled %.1fs >= deadline %gs; "
                      "crash bundle written to %s", span.point,
                      span.label or "-", time.monotonic() - span.start,
                      span.deadline, path)
        profiler = sys.modules.get(f"{__package__}.profiler")
        if profiler is not None:
            profiler.record_stall(span.point,
                                  time.monotonic() - span.start, path)
        return path
    except Exception as e:
        _logger.error("watchdog: failed to write crash bundle for %r: %s",
                      span.point, e)
        return None
    finally:
        span.bundle_ready.set()


def _dump_tracebacks(path):
    import faulthandler

    with open(path, "w") as f:
        f.write(f"# all-thread tracebacks, pid {os.getpid()}, "
                f"{time.strftime('%Y-%m-%d %H:%M:%S')}\n")
        f.flush()
        faulthandler.dump_traceback(file=f, all_threads=True)


def _capturing():
    """Whether the port has a CUDA graph capture open (no CUDA call from
    this thread then)."""
    comp = sys.modules.get(f"{__package__}.compile")
    return comp is not None and comp.capturing()


def _report(span):
    from . import faults as _faults

    report = {
        "point": span.point,
        "label": span.label,
        "thread": span.thread,
        "elapsed_s": round(time.monotonic() - span.start, 3),
        "deadline_s": span.deadline,
        "time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "pid": os.getpid(),
        "config": describe(),
        "active_spans": _active_spans_snapshot(),
        "faults": {k: {"invocations": c, "fires": fi}
                   for k, (c, fi) in _faults.stats().items()},
    }
    profiler = sys.modules.get(f"{__package__}.profiler")
    report["profiler"] = profiler.dumps() if profiler is not None \
        else "<profiler not imported>"
    if _capturing():
        report["memory"] = "<not read: a CUDA graph capture is open>"
    else:
        try:
            from .telemetry import memory as _tele_memory

            report["memory"] = _tele_memory.oom_report()
        except Exception as e:
            report["memory"] = f"<unavailable: {e}>"
    buckets = sys.modules.get(f"{__package__}.kvstore.buckets")
    if buckets is not None:
        report["kvstore_buckets"] = buckets.comm_stats()
    return report


# ----------------------------------------------------------------- monitor --

def _start_monitor(gen, stop):
    t = threading.Thread(target=_monitor_loop, args=(gen, stop),
                         name="mxtpu-watchdog-monitor", daemon=True)
    t.start()


def _monitor_interval(cfg):
    if cfg.interval is not None:
        return max(0.02, cfg.interval)
    ds = list(cfg.deadlines.values())
    if cfg.default is not None:
        ds.append(cfg.default)
    return min(5.0, max(0.05, min(ds) / 4.0))


def _monitor_loop(gen, stop):
    """Scan open spans; walk the warn -> bundle ladder for overdue ones.
    One thread per configure() generation; a newer configure sets
    ``stop``, and the thread returns at once."""
    while True:
        cfg = _CFG
        if cfg is None or gen != _monitor_gen or stop.is_set():
            return
        try:
            now = time.monotonic()
            with _lock:
                spans = list(_spans.values())
            for s in spans:
                elapsed = now - s.start
                if not s.warned and elapsed >= s.deadline * cfg.warn_fraction:
                    s.warned = True
                    _flight.rec("watchdog.warn", s.point, s.label)
                    _logger.warning(
                        "watchdog: %r (%s) has been blocking for %.1fs "
                        "(deadline %gs)", s.point, s.label or "-", elapsed,
                        s.deadline)
                if elapsed >= s.deadline:
                    if not s.bundled:
                        _write_bundle(s)
                    s.stalled.set()
        except Exception as e:  # the monitor must never die
            _logger.error("watchdog monitor error: %s", e)
        stop.wait(_monitor_interval(cfg))


# ------------------------------------------------- the caller's state ------

# the port's thread-local holders, as (module, attribute path); read from
# sys.modules, so a module nobody imported is not imported here
_CARRIED = (("autograd", "_tls"), ("context", "Context._tls"),
            ("util", "_tls"), ("attribute", "AttrScope._tls"),
            ("name", "NameManager._tls"), ("gluon.block", "_BlockScope._tls"),
            ("gluon.parameter", "_tls"), ("compile", "_tls"),
            ("compile", "_streams"), ("kernels", "_tls"),
            ("telemetry.trace", "_tls"), ("ops.registry", "_tls"),
            ("numpy", "_tls"))


def _holders():
    for mod_name, path in _CARRIED:
        obj = sys.modules.get(f"{__package__}.{mod_name}")
        for part in path.split(".") if obj is not None else ():
            obj = getattr(obj, part, None)
        if obj is not None:
            yield obj


def _torch_state():
    """torch's thread-local state in this thread: grad and inference
    modes, autocast per device type, and the CUDA device and stream."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    autocast = []
    for dev in ("cuda", "cpu"):
        if torch.is_autocast_enabled(dev):
            autocast.append((dev, torch.get_autocast_dtype(dev)))
    cuda = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        cuda = torch.cuda.current_stream()
    return (torch.is_grad_enabled(), torch.is_inference_mode_enabled(),
            autocast, torch.is_autocast_cache_enabled(), cuda)


def carried():
    """A snapshot of this thread's state (torch's and the port's) as a
    context manager factory: ``with snap():`` in another thread runs that
    thread under it (the stacks copied)."""
    port = [(tls, {k: (list(v) if isinstance(v, list) else v)
                   for k, v in vars(tls).items()}) for tls in _holders()]
    torch_state = _torch_state()

    @contextlib.contextmanager
    def apply():
        for tls, values in port:
            for k, v in values.items():
                setattr(tls, k, list(v) if isinstance(v, list) else v)
        with contextlib.ExitStack() as stack:
            if torch_state is not None:
                import torch

                grad, inference, autocast, cache, stream = torch_state
                stack.enter_context(torch.set_grad_enabled(grad))
                if inference:
                    stack.enter_context(torch.inference_mode(True))
                for dev, dtype in autocast:
                    stack.enter_context(torch.autocast(
                        dev, dtype=dtype, cache_enabled=cache))
                if stream is not None:
                    stack.enter_context(torch.cuda.device(stream.device))
                    stack.enter_context(torch.cuda.stream(stream))
            yield

    return apply


# ----------------------------------------------------- deadline-bounded sync --

_tls = threading.local()


def _register(point, label, deadline):
    global _span_seq
    span = _Span(point, label, deadline)
    with _lock:
        _span_seq += 1
        key = _span_seq
        _spans[key] = span
    return key, span


def _unregister(key):
    with _lock:
        _spans.pop(key, None)


def _abort(span):
    """Last-resort terminal: attempt a final checkpoint, then exit 86."""
    hook = _last_resort
    if hook is not None:
        try:
            _logger.error("watchdog: attempting last-resort checkpoint "
                          "before abort")
            hook()
        except Exception as e:
            _logger.error("watchdog: last-resort checkpoint failed: %s", e)
    _logger.error("watchdog: aborting (exit %d) after stall at %r",
                  ABORT_EXIT_CODE, span.point)
    _exit_fn(ABORT_EXIT_CODE)


def sync(point, fn, label=None):
    """Run blocking ``fn()`` under the watchdog contract for ``point``.

    Off, or no deadline for ``point``: ``fn`` runs inline.
    ``action:observe``: inline inside a registered span (the monitor
    warns and bundles; nothing raises). ``action:raise`` / ``abort``:
    ``fn`` runs in a daemon waiter thread under the caller's state
    (:func:`carried`) and the caller waits at most the deadline; ``fn``'s
    result or exception comes back unchanged, or at the deadline the
    bundle is written and :class:`StallError` raised (or the last resort
    runs and the process exits 86). Nested syncs run inline: the outer
    span bounds them."""
    _flight.rec("sync", point, label)
    cfg = _CFG
    if cfg is None:
        if _loaded_env:
            return fn()
        _ensure_env()
        cfg = _CFG
        if cfg is None:
            return fn()
    limit = cfg.deadline_for(point)
    if limit is None or getattr(_tls, "in_sync", False):
        return fn()
    key, span = _register(point, label, limit)
    beat(point, f"begin {label or point}")
    try:
        if cfg.action == "observe":
            return fn()
        return _bounded(cfg, span, fn)
    finally:
        _unregister(key)
        beat(point, f"end {label or point}")


def _bounded(cfg, span, fn):
    box = {}
    done = threading.Event()
    state = carried()

    def runner():
        _tls.in_sync = True  # the waiter IS the span
        try:
            with state():
                box["value"] = fn()
        except BaseException as e:
            box["error"] = e
        finally:
            done.set()

    waiter = threading.Thread(target=runner, daemon=True,
                              name=f"mxtpu-waiter-{span.point}")
    waiter.start()
    end = span.start + span.deadline
    warn_at = span.start + span.deadline * cfg.warn_fraction
    while True:
        now = time.monotonic()
        if now >= end:
            break
        nxt = end if span.warned else min(end, warn_at)
        if done.wait(timeout=max(0.001, min(nxt - now, 0.25))):
            if "error" in box:
                raise box["error"]
            return box["value"]
        if not span.warned and time.monotonic() >= warn_at:
            span.warned = True
            _logger.warning(
                "watchdog: %r (%s) has been blocking for %.1fs "
                "(deadline %gs)", span.point, span.label or "-",
                time.monotonic() - span.start, span.deadline)
    if done.is_set():  # finished exactly on the boundary: not a stall
        if "error" in box:
            raise box["error"]
        return box["value"]
    bundle = _write_bundle(span)
    span.stalled.set()
    if cfg.action == "abort":
        _abort(span)
    raise StallError(span.point, span.label,
                     time.monotonic() - span.start, span.deadline,
                     bundle or span.bundle)
