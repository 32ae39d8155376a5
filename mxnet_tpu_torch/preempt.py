"""Graceful preemption drain: SIGTERM -> finish the step, checkpoint, exit.

Counterpart of ``mxnet_tpu/preempt.py``, with its exit codes, environment
variables and drain record.

1. :func:`install` hooks SIGTERM/SIGINT (from the main thread only, as
   Python allows). The handler only raises a **drain flag** and records
   the event, so the step in flight finishes; a second signal exits at
   once with the reschedule code.
2. The loops poll :func:`requested`: ``ShardedTrainer.step`` raises
   :class:`DrainRequested` rather than start a new step; the Estimator's
   and ``Module.fit``'s loops drain after the batch in flight;
   ``serving.ModelServer.run_until_drained`` stops admission, answers
   every admitted request and exits 75.
3. :func:`drain` writes the final checkpoint (an explicit ``save``, or the
   hook installed with ``watchdog.set_last_resort``, which
   ``ShardedTrainer.save_checkpoint`` / ``resume`` register), records a
   drain event JSON beside the crash bundles and exits with
   :func:`exit_code` (default 75, ``EX_TEMPFAIL``).

The exit ladder supervisors dispatch on::

    75   graceful preemption drain (reschedule and resume)
    76   peer lost: a kvstore collective raised PeerLostError
    86   watchdog stall abort (watchdog.ABORT_EXIT_CODE)
    137  SIGKILL: a hard preemption; resume from the last checkpoint

Environment::

    MXNET_TPU_PREEMPT            install at the trainer's, the Estimator's
                                 or fit's start: "1" (SIGTERM+SIGINT),
                                 "sigterm", "sigterm,sigint"; "0" or
                                 unset: only an explicit install()
    MXNET_TPU_PREEMPT_EXIT_CODE  drain exit code (default 75)
    MXNET_TPU_PREEMPT_DIR        drain-event directory (default: the
                                 watchdog's crash dir)
    MXNET_TPU_PREEMPT_RESHARD    "0" forbids ShardedTrainer.resume across
                                 a topology change

The ``preempt`` fault mode (:mod:`mxnet_tpu_torch.faults`) sends SIGTERM
at a named point, e.g. ``MXNET_TPU_FAULTS="trainer.step:preempt@6"``.
The JAX package's gang record (``MXTPU_GANG_DIR``) and final gang beat
belong to its elastic supervisor, which the port does not have.
"""
from __future__ import annotations

import json
import os
import signal as _signal
import threading
import time

from . import log as _log
from .telemetry import flight as _flight

__all__ = ["DrainRequested", "DRAIN_EXIT_CODE", "PEERLOST_EXIT_CODE",
           "EXIT_LADDER", "canonical_exit", "classify_exit",
           "exit_severity", "most_severe", "install", "installed",
           "uninstall", "maybe_install_from_env", "requested", "request",
           "clear", "event", "drain", "exit_code", "drain_dir",
           "last_drain", "describe"]

DRAIN_EXIT_CODE = 75     # EX_TEMPFAIL: transient failure, please reschedule
PEERLOST_EXIT_CODE = 76  # EX_PROTOCOL: a gang peer died under a collective

#: the exit-code ladder, least to most severe; anything unlisted is an
#: "error" (a real bug, not a reschedule)
EXIT_LADDER = {0: "ok", DRAIN_EXIT_CODE: "drain",
               PEERLOST_EXIT_CODE: "peer-lost", 86: "watchdog-abort",
               137: "killed"}

_SEVERITY = {code: i for i, code in enumerate(EXIT_LADDER)}
_UNKNOWN_SEVERITY = len(EXIT_LADDER)


def canonical_exit(rc):
    """A ``Popen.returncode`` (negative: killed by signal N) in the shell
    convention ``128 + N`` (SIGKILL is 137)."""
    if rc is None:
        return None
    rc = int(rc)
    return 128 - rc if rc < 0 else rc


def classify_exit(rc) -> str:
    """The ladder's name for an exit code: ``ok`` / ``drain`` /
    ``peer-lost`` / ``watchdog-abort`` / ``killed`` / ``error``."""
    return EXIT_LADDER.get(canonical_exit(rc), "error")


def exit_severity(rc) -> int:
    """The ladder position (higher is worse); unknown codes rank worst."""
    return _SEVERITY.get(canonical_exit(rc), _UNKNOWN_SEVERITY)


def most_severe(codes):
    """The most severe exit code of an iterable (0 when empty)."""
    best, best_sev = 0, -1
    for rc in codes:
        rc = canonical_exit(rc)
        if rc is None:
            continue
        sev = _SEVERITY.get(rc, _UNKNOWN_SEVERITY)
        if sev > best_sev:
            best, best_sev = rc, sev
    return best


_logger = _log.get_logger("mxnet_tpu.preempt")

_lock = threading.Lock()
_installed: dict = {}   # signum -> previous handler
_requested = False
_event = None
_exit_fn = os._exit  # test seam for the second-signal path

_SIGNALS = {"sigterm": _signal.SIGTERM, "sigint": _signal.SIGINT}


class DrainRequested(RuntimeError):
    """A drain is pending: no new step may start.

    ``ShardedTrainer.step`` raises it when the flag is up; the previous
    step has completed, so the caller writes its final checkpoint (or
    calls :func:`drain`) and exits for reschedule."""

    def __init__(self, ev=None):
        self.event = dict(ev or {})
        why = self.event.get("signal") or self.event.get("reason") or "?"
        super().__init__(
            f"preemption drain requested ({why}); finish up, write a "
            "final checkpoint (preempt.drain()) and exit for reschedule")


def exit_code() -> int:
    """The drain exit code (``MXNET_TPU_PREEMPT_EXIT_CODE``, default 75)."""
    try:
        return int(os.environ.get("MXNET_TPU_PREEMPT_EXIT_CODE",
                                  DRAIN_EXIT_CODE))
    except ValueError:
        return DRAIN_EXIT_CODE


def _signal_name(signum):
    try:
        return _signal.Signals(signum).name
    except ValueError:
        return f"signal {signum}"


def _handler(signum, frame):
    global _requested, _event
    if _requested:
        # a second delivery: the grace is over, exit now with the
        # reschedule code (the checkpoint writes are atomic)
        _logger.error("preempt: second %s during drain; exiting %d "
                      "immediately", _signal_name(signum), exit_code())
        _exit_fn(exit_code())
        return  # reached only through the test seam
    _requested = True
    _event = {"signal": _signal_name(signum), "signum": int(signum),
              "t_wall": time.time(), "t_mono": time.monotonic(),
              "pid": os.getpid()}
    _flight.rec("preempt.request", "signal", _signal_name(signum))
    _logger.warning(
        "preempt: received %s; draining (the step in flight finishes, "
        "then a final checkpoint is written and the process exits %d)",
        _signal_name(signum), exit_code())


def _parse_signals(spec):
    if spec is None or spec.strip() in ("", "1", "true", "yes"):
        return (_signal.SIGTERM, _signal.SIGINT)
    out = []
    for tok in spec.replace(";", ",").split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        if tok not in _SIGNALS:
            raise ValueError(f"unknown MXNET_TPU_PREEMPT signal {tok!r}; "
                             f"expected one of {sorted(_SIGNALS)}")
        out.append(_SIGNALS[tok])
    return tuple(out) or (_signal.SIGTERM, _signal.SIGINT)


def install(signals=None):
    """Install the drain handlers (idempotent; main thread only).

    Returns True when they are installed, False on another thread, where
    Python forbids ``signal.signal`` (a loop there can still poll
    :func:`requested`, which :func:`request` raises)."""
    if signals is None:
        signals = (_signal.SIGTERM, _signal.SIGINT)
    with _lock:
        try:
            for s in signals:
                if s not in _installed:
                    _installed[s] = _signal.signal(s, _handler)
        except ValueError:
            _logger.warning("preempt: cannot install signal handlers "
                            "outside the main thread")
            return False
    return True


def installed() -> bool:
    return bool(_installed)


def uninstall():
    """Restore the previous handlers and clear the drain state."""
    with _lock:
        for s, prev in list(_installed.items()):
            try:
                _signal.signal(s, prev)
            except (ValueError, TypeError):
                pass
        _installed.clear()
    clear()


def maybe_install_from_env():
    """Install per ``MXNET_TPU_PREEMPT`` (nothing when unset or "0");
    the trainer, the Estimator and ``Module.fit`` call it."""
    spec = os.environ.get("MXNET_TPU_PREEMPT", "")
    if not spec or spec.strip() in ("0", "false", "no"):
        return False
    if _installed:
        return True
    try:
        return install(_parse_signals(spec))
    except ValueError as e:
        _logger.warning("ignoring invalid MXNET_TPU_PREEMPT: %s", e)
        return False


def requested() -> bool:
    """True once a drain has been requested (one global read)."""
    return _requested


def request(reason="api"):
    """Raise the drain flag from code (the flag the handler raises)."""
    global _requested, _event
    with _lock:
        if not _requested:
            _requested = True
            _event = {"reason": str(reason), "t_wall": time.time(),
                      "t_mono": time.monotonic(), "pid": os.getpid()}
            _flight.rec("preempt.request", "api", str(reason))
    return _event


def clear():
    """Reset the drain flag and event."""
    global _requested, _event
    with _lock:
        _requested = False
        _event = None


def event():
    """A copy of the pending drain request's event, or None."""
    ev = _event
    return dict(ev) if ev else None


# ------------------------------------------------------------- the drain ---

def drain_dir():
    """Where drain records go: ``MXNET_TPU_PREEMPT_DIR``, else the
    watchdog's crash dir."""
    d = os.environ.get("MXNET_TPU_PREEMPT_DIR")
    if d:
        return d
    from . import watchdog as _watchdog

    return _watchdog.crash_dir()


def _write_event(ev, directory=None):
    from .checkpoint import atomic_write

    root = directory or drain_dir()
    try:
        os.makedirs(root, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(root, f"drain-{stamp}-p{os.getpid()}.json")
        payload = json.dumps(ev, indent=1, sort_keys=True, default=repr)

        def writer(tmp):
            with open(tmp, "w") as f:
                f.write(payload)

        atomic_write(path, writer)
        return path
    except OSError as e:
        _logger.error("preempt: failed to record drain event: %s", e)
        return None


def last_drain(directory=None):
    """The newest ``drain-*.json`` record, parsed, or None."""
    root = directory or drain_dir()
    try:
        cands = [os.path.join(root, n) for n in os.listdir(root)
                 if n.startswith("drain-") and n.endswith(".json")]
    except OSError:
        return None
    for path in sorted(cands, key=os.path.getmtime, reverse=True):
        try:
            with open(path) as f:
                ev = json.load(f)
            ev["path"] = path
            return ev
        except (OSError, ValueError):
            continue
    return None


def drain(save=None, exit=True, code=None, directory=None):
    """The drain's end: final checkpoint, drain record, exit.

    save : callable writing the final checkpoint; None runs the
        ``watchdog.set_last_resort`` hook; False skips the save (the
        caller has checkpointed).
    exit : raise ``SystemExit(code)`` after recording; False returns the
        event dict instead.
    """
    ev = event() or {"reason": "drain() without a pending request",
                     "t_wall": time.time(), "pid": os.getpid()}
    ev["exit_code"] = int(code if code is not None else exit_code())
    hook = save
    if hook is None:
        from . import watchdog as _watchdog

        hook = _watchdog.last_resort()
    if hook is False or hook is None:
        ev["final_checkpoint"] = ("skipped" if hook is False else
                                  "no hook installed")
    else:
        try:
            result = hook()
            ev["final_checkpoint"] = "written"
            if isinstance(result, dict):  # a manager's {name: path}
                ev["checkpoint_files"] = {k: str(v)
                                          for k, v in result.items()}
        except Exception as e:  # a failed save must not hide the drain
            _logger.error("preempt: final checkpoint failed: %s", e)
            ev["final_checkpoint"] = f"failed: {type(e).__name__}: {e}"
    _flight.rec("preempt.drain", "drain",
                ev.get("signal") or ev.get("reason"))
    ev["flight_tail"] = _flight.tail(64)
    ev["recorded"] = _write_event(ev, directory)
    _logger.warning("preempt: drained (%s); final checkpoint: %s; "
                    "exiting %d for reschedule",
                    ev.get("signal") or ev.get("reason"),
                    ev["final_checkpoint"], ev["exit_code"])
    if exit:
        raise SystemExit(ev["exit_code"])
    return ev


def describe():
    """The knobs and the state as a plain dict."""
    return {"installed": sorted(_signal_name(s) for s in _installed),
            "requested": _requested, "event": event(),
            "exit_code": exit_code(), "drain_dir": drain_dir(),
            "env": os.environ.get("MXNET_TPU_PREEMPT", "<unset>")}
