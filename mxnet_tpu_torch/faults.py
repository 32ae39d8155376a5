"""Deterministic fault injection and retry/backoff (counterpart of
``mxnet_tpu/faults.py``).

Named injection points wired through the port:

    ``serving.batch``  every served batch (serving/batcher.py), before it
                       runs: ``raise`` fails the batch (its requests get a
                       RequestError, the server keeps serving), ``delay``
                       and ``hang`` stall it
    ``modelbus.publish``  every bus record publish (modelbus.py), fired
                       AFTER the finite gate: ``nan`` poisons the record's
                       first parameter (in-transit corruption the
                       subscriber must reject and quarantine),
                       ``delay``/``hang`` stall the publisher
    ``modelbus.apply``  every subscriber apply attempt, on the raw payload
                       bytes: ``corrupt`` flips bytes the CRC validation
                       must catch (reject: crc_mismatch), ``delay``/``hang``
                       stall the watcher, ``raise`` rejects as apply_error
    ``ckpt.write``     every atomic file write (checkpoint.py), before it
    ``kvstore.push``   every kvstore push (kvstore/kvstore.py, both stores)
    ``kvstore.sync``   a blocking cross-worker sum, a barrier, and each
                       bucket reduction the pipeline resolves
                       (kvstore/buckets.py)
    ``trainer.step``   every ``ShardedTrainer.step``, on the batch before
                       the (captured) step runs: ``nan`` poisons it
    ``host.sync``      every blocking host read of an NDArray
                       (``asnumpy``, ``wait_to_read``)
    ``io.fetch``       each ``PrefetchingIter`` worker's fetch
    ``io.decode``      each ``ImageRecordIter`` batch and each
                       ``TokenRecordIter`` read; a JPEG record the batch
                       decode rejects is decoded again under :func:`retry`

A point in a hot path is guarded by ``if faults.ARMED:``, one attribute
read when no schedule is armed. No point sits inside a captured CUDA
graph: each fires in the host code around a replay.

Faults are configured programmatically (:func:`configure`) or through the
``MXNET_TPU_FAULTS`` environment variable, read once at first use (seed:
``MXNET_TPU_FAULTS_SEED``). Every point counts its own invocations, and
probabilistic triggers draw from a dedicated ``random.Random(seed)``
stream.

Spec grammar (semicolon-separated entries), as the JAX package's::

    <point>:<mode>[@<trigger>][:<arg>]

    mode     raise | delay | corrupt | nan | kill | hang | preempt
             | peerloss
    trigger  N        fire on the N-th invocation only (1-based)
             N+       fire on every invocation from the N-th onward
             N,M,...  fire on the listed invocations
             *        fire on every invocation
             pP       fire with probability P per invocation (seeded)
             (default: 1 -- fire on the first invocation)
    arg      delay: sleep seconds (default 0.05)
             hang: wedge seconds (default 3600)
             peerloss: the gang rank to SIGKILL (required)

Modes at a point ``faults.point(name, payload=None)``:

    raise    raise :class:`InjectedFault`
    delay    sleep ``arg`` seconds, then continue
    corrupt  a bytes payload comes back with flipped bytes (callers use
             the return value); other payloads fall back to ``nan``
    nan      a numpy array payload comes back as a NaN-poisoned copy
    kill     SIGKILL the process
    preempt  SIGTERM the process and continue
    hang     block the calling thread for ``arg`` seconds
    peerloss parsed, but firing it raises
             :class:`~mxnet_tpu_torch.base.MXNetError`: the elastic gang
             supervisor it signals is not ported

:func:`retry` is the exponential-backoff wrapper.
"""
from __future__ import annotations

import functools
import os
import random as _pyrandom
import threading
import time

__all__ = ["InjectedFault", "configure", "reset", "point", "active",
           "stats", "retry", "ARMED"]


class InjectedFault(RuntimeError):
    """Raised by an injection point whose schedule fired (mode=raise)."""


class _PointSpec:
    __slots__ = ("mode", "trigger", "arg", "rng")

    def __init__(self, mode, trigger, arg, seed):
        self.mode = mode
        self.trigger = trigger  # ("set", {n,..}) | ("from", n) | ("p", prob)
        self.arg = arg
        # dedicated stream: deterministic regardless of global RNG use
        self.rng = _pyrandom.Random(seed)

    def fires(self, count):
        kind, val = self.trigger
        if kind == "set":
            return count in val
        if kind == "from":
            return count >= val
        return self.rng.random() < val  # "p"


_lock = threading.Lock()
_specs = {}   # point name -> _PointSpec
_counts = {}  # point name -> invocation count
_fired = {}   # point name -> fire count
_loaded_env = False
# False once the schedule is known to be empty: the hot paths' gate. True
# until the environment has been read, so the first hit reads it.
ARMED = True


def _parse_trigger(tok):
    if tok == "*":
        return ("from", 1)
    if tok.startswith("p"):
        return ("p", float(tok[1:]))
    if tok.endswith("+"):
        return ("from", int(tok[:-1]))
    return ("set", {int(t) for t in tok.split(",")})


def _parse(spec, seed):
    """Parse a spec string into {point: _PointSpec}."""
    out = {}
    for i, entry in enumerate(e for e in spec.split(";") if e.strip()):
        parts = entry.strip().split(":")
        if len(parts) < 2:
            raise ValueError(
                f"bad MXNET_TPU_FAULTS entry {entry!r}: expected "
                "<point>:<mode>[@<trigger>][:<arg>]")
        name, mode_tok = parts[0], parts[1]
        arg = parts[2] if len(parts) > 2 else None
        if "@" in mode_tok:
            mode, trig_tok = mode_tok.split("@", 1)
        else:
            mode, trig_tok = mode_tok, "1"
        if mode not in ("raise", "delay", "corrupt", "nan", "kill", "hang",
                        "preempt", "peerloss"):
            raise ValueError(f"unknown fault mode {mode!r} in {entry!r}")
        # per-point sub-seed keeps streams independent yet reproducible
        out[name] = _PointSpec(mode, _parse_trigger(trig_tok),
                               arg, seed + i * 7919)
    return out


def configure(spec=None, seed=0):
    """Install a fault schedule (replacing any previous one).

    spec : str in the grammar above, or dict {point: spec-entry-tail}
        e.g. ``{"ckpt.write": "raise@2"}``, or None to clear.
    seed : int — seeds the probabilistic triggers deterministically.
    """
    global _loaded_env, ARMED
    if isinstance(spec, dict):
        spec = ";".join(f"{k}:{v}" for k, v in spec.items())
    with _lock:
        _specs.clear()
        _counts.clear()
        _fired.clear()
        if spec:
            _specs.update(_parse(spec, seed))
        _loaded_env = True  # explicit configure overrides the env
        ARMED = bool(_specs)


def reset():
    """Clear the schedule and all counters (env var will NOT be re-read)."""
    configure(None)


def _ensure_env():
    global _loaded_env, ARMED
    if _loaded_env:
        return
    with _lock:
        if _loaded_env:
            return
        env = os.environ.get("MXNET_TPU_FAULTS", "")
        if env:
            _specs.update(_parse(env, int(os.environ.get(
                "MXNET_TPU_FAULTS_SEED", "0"))))
        _loaded_env = True
        ARMED = bool(_specs)


def active() -> bool:
    """True when any injection point is armed (fast gate for hot paths)."""
    _ensure_env()
    return bool(_specs)


def stats():
    """{point: (invocations, fires)} for every point that has been hit."""
    with _lock:
        return {k: (_counts.get(k, 0), _fired.get(k, 0))
                for k in set(_counts) | set(_fired)}


def _corrupt_bytes(payload, rng):
    b = bytearray(payload)
    if not b:
        return bytes(b)
    for _ in range(max(1, len(b) // 64)):
        i = rng.randrange(len(b))
        b[i] ^= 0xFF
    return bytes(b)


def _poison_nan(payload):
    if type(payload).__module__.startswith("torch"):
        # a tensor is poisoned where it lies, in a copy
        import torch

        out = payload.detach().clone(memory_format=torch.contiguous_format)
        if not out.is_floating_point():
            out = out.float()
        flat = out.view(-1)
        flat[: max(1, flat.numel() // 8)] = float("nan")
        return out
    import numpy as _np

    arr = _np.array(_np.asarray(payload), copy=True)
    if arr.dtype.kind != "f":
        arr = arr.astype(_np.float32)
    flat = arr.reshape(-1)
    flat[: max(1, flat.size // 8)] = _np.nan
    return arr


def point(name, payload=None):
    """Hit the named injection point.

    Returns `payload` (possibly corrupted — callers that pass payloads must
    use the return value), raises :class:`InjectedFault`, sleeps, or kills
    the process, per the armed schedule. With no schedule armed this is a
    counter increment and a dict miss — cheap enough for per-batch paths.
    """
    _ensure_env()
    if not _specs:
        return payload
    with _lock:
        count = _counts.get(name, 0) + 1
        _counts[name] = count
        spec = _specs.get(name)
        if spec is None or not spec.fires(count):
            return payload
        _fired[name] = _fired.get(name, 0) + 1
    if spec.mode == "raise":
        raise InjectedFault(f"injected fault at {name!r} "
                            f"(invocation {count})")
    if spec.mode == "delay":
        time.sleep(float(spec.arg) if spec.arg else 0.05)
        return payload
    if spec.mode == "hang":
        # chunked so signals (per-test SIGALRM) still interrupt promptly
        end = time.monotonic() + (float(spec.arg) if spec.arg else 3600.0)
        while True:
            remaining = end - time.monotonic()
            if remaining <= 0:
                return payload
            time.sleep(min(0.25, remaining))
    if spec.mode == "kill":
        import signal

        os.kill(os.getpid(), signal.SIGKILL)  # no return
    if spec.mode == "preempt":
        import signal

        # SIGTERM to self: with preempt.install()'ed handlers this only
        # raises the drain flag (execution continues and the step
        # finishes); without them the interpreter dies like a real
        # unhandled preemption
        os.kill(os.getpid(), signal.SIGTERM)
        return payload
    if spec.mode == "peerloss":
        from .base import MXNetError

        raise MXNetError(f"fault mode 'peerloss' at {name!r} is not ported: "
                         "it signals a gang peer through the elastic "
                         "supervisor, which mxnet_tpu_torch does not have")
    if spec.mode == "corrupt" and isinstance(payload, (bytes, bytearray)):
        return _corrupt_bytes(payload, spec.rng)
    if payload is not None:  # corrupt (non-bytes) and nan both poison
        return _poison_nan(payload)
    raise InjectedFault(f"injected fault at {name!r} (mode "
                        f"{spec.mode!r} with no payload to corrupt)")


# ----------------------------------------------------------------- retry ---

def retry(fn=None, *, retries=3, backoff=0.05, jitter=0.0, deadline=None,
          retry_on=(Exception,), on_retry=None):
    """Exponential-backoff retry decorator/wrapper.

    Replaces ad-hoc retry loops (io decode PIL fallback, model-zoo fetch).
    Usable three ways::

        @retry                                   # defaults
        @retry(retries=5, retry_on=(OSError,))   # configured decorator
        retry(fn, retries=5)(args...)            # inline wrapper

    retries : attempts AFTER the first call (total calls = retries + 1).
    backoff : initial sleep; doubles each retry (exponential).
    jitter  : fraction of the sleep drawn uniformly at random and added
        (0.0 = fully deterministic — the default, so tests and seeded
        chaos runs replay exactly).
    deadline : total-elapsed-time cap in seconds across ALL attempts and
        backoff sleeps; once starting the next backoff would cross it the
        last exception propagates instead. Bounds retry storms so a
        persistently failing call cannot itself become a hang (the
        attempt-count cap alone grows exponentially in wall-clock).
    retry_on : exception classes that trigger a retry; anything else
        propagates immediately.
    on_retry : optional callback ``(attempt, exc)`` per failed attempt
        (logging / profiler hooks).
    """
    if fn is not None and not callable(fn):
        raise TypeError("retry: first argument must be callable; use "
                        "keyword arguments for configuration")

    def deco(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            delay = backoff
            start = time.monotonic()
            for attempt in range(retries + 1):
                try:
                    return func(*args, **kwargs)
                except retry_on as exc:
                    if attempt == retries:
                        raise
                    sleep = delay
                    if jitter:
                        sleep += delay * jitter * _pyrandom.random()
                    if deadline is not None and \
                            time.monotonic() - start + sleep >= deadline:
                        raise  # the next attempt would bust the time cap
                    if on_retry is not None:
                        on_retry(attempt + 1, exc)
                    if sleep > 0:
                        time.sleep(sleep)
                    delay *= 2

        return wrapper

    return deco(fn) if fn is not None else deco
