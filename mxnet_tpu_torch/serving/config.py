"""Serving knobs: defaults and the ``MXNET_TPU_SERVING`` environment
grammar (counterpart of ``mxnet_tpu/serving/config.py``).

One environment variable, read once at first use (so subprocesses inherit
a configuration), overridable through :func:`configure`. Entries are
separated by ``,`` or ``;``::

    buckets:<b1|b2|...>   padded batch buckets per model (default
                          2|4|8|16|32; the smallest is 2, as in the JAX
                          package)
    max_queue:<N>         admission bound: rows waiting per model before
                          submit() fast-rejects with ServerBusyError
                          (default 1024)
    max_wait_ms:<F>       how long the collector holds an underfull batch
                          waiting for batch-mates (default 2.0)
    timeout_ms:<F>        default ServingFuture.result() deadline (default
                          30000)
    stage:<0|1>           copy each padded batch to the card on a side
                          stream from pinned memory, overlapping the
                          running batch (default 1); off, the runner
                          copies it before the replay
    cache:<0|1>           content-addressed prediction cache in front of
                          the batcher (key = model version x input bytes;
                          default 0)
    cache_entries:<N>     LRU capacity of that cache per model (default
                          4096)

Examples::

    MXNET_TPU_SERVING="buckets:2|8|32,max_wait_ms:5"
    serving.configure({"max_queue": 64}, max_wait_ms=1.0)

Callers also override them per server or model (``ModelServer(max_queue=
...)``, ``ServedModel.from_block(buckets=...)``). :func:`coerce` validates
one setting.
"""
from __future__ import annotations

import os
import re
import threading

__all__ = ["configure", "configure_from_env", "effective", "describe",
           "DEFAULTS", "coerce"]

ENV = "MXNET_TPU_SERVING"

DEFAULTS = {
    "buckets": (2, 4, 8, 16, 32),
    "max_queue": 1024,
    "max_wait_ms": 2.0,
    "timeout_ms": 30000.0,
    "stage": True,
    "cache": False,
    "cache_entries": 4096,
}

_lock = threading.Lock()
_CFG: dict | None = None
_loaded_env = False


def _parse_buckets(val):
    try:
        buckets = tuple(sorted({int(b) for b in val.split("|") if b.strip()}))
    except ValueError:
        raise ValueError(f"bad serving buckets {val!r}: expected "
                         "'|'-separated integers, e.g. buckets:2|4|8")
    if not buckets or any(b < 1 for b in buckets):
        raise ValueError(f"bad serving buckets {val!r}: need at least one "
                         "positive batch size")
    return buckets


def _coerce(key, val):
    if key == "buckets":
        if isinstance(val, str):
            return _parse_buckets(val)
        buckets = tuple(sorted({int(b) for b in val}))
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"bad serving buckets {val!r}")
        return buckets
    if key in ("max_queue", "cache_entries"):
        n = int(val)
        if n < 1:
            raise ValueError(f"serving {key} must be >= 1, got {n}")
        return n
    if key in ("max_wait_ms", "timeout_ms"):
        f = float(val)
        if f < 0:
            raise ValueError(f"serving {key} must be >= 0, got {f}")
        return f
    if key in ("stage", "cache"):
        if isinstance(val, str):
            return val.strip().lower() not in ("0", "false", "off", "no")
        return bool(val)
    raise ValueError(
        f"unknown serving option {key!r}; expected one of {sorted(DEFAULTS)}")


coerce = _coerce


def _parse(spec):
    cfg = dict(DEFAULTS)
    for entry in re.split(r"[;,]", spec):
        entry = entry.strip()
        if not entry:
            continue
        key, sep, val = entry.partition(":")
        key, val = key.strip(), val.strip()
        if not sep or not val:
            raise ValueError(
                f"bad {ENV} entry {entry!r}: expected <option>:<value>")
        cfg[key] = _coerce(key, val)
    return cfg


def configure(spec=None, **options):
    """Install a serving configuration (replacing any previous one).

    spec : str in the grammar above, dict ``{option: value}``, or None to
        fall back to the defaults. ``options`` keyword overrides apply on
        top. Pass nothing at all to reset to defaults/env precedence.
    """
    global _CFG, _loaded_env
    if isinstance(spec, dict):
        cfg = dict(DEFAULTS)
        for k, v in spec.items():
            cfg[k] = _coerce(k, v)
    elif spec:
        cfg = _parse(spec)
    else:
        cfg = dict(DEFAULTS)
    for k, v in options.items():
        cfg[k] = _coerce(k, v)
    with _lock:
        _loaded_env = True  # explicit configure overrides the env
        _CFG = cfg
    return dict(cfg)


def configure_from_env(force=True):
    """(Re-)read ``MXNET_TPU_SERVING`` — tests use it to restore the
    ambient configuration after exercising explicit ones."""
    global _loaded_env, _CFG
    if force:
        with _lock:
            _loaded_env = False
            _CFG = None
    _ensure_env()


def _ensure_env():
    global _loaded_env, _CFG
    if _loaded_env:
        return
    with _lock:
        if _loaded_env:
            return
        _loaded_env = True
        env = os.environ.get(ENV, "")
        if env:
            try:
                _CFG = _parse(env)
            except ValueError as e:
                from .. import log as _log

                _log.get_logger("mxnet_tpu_torch.serving").warning(
                    "ignoring invalid %s: %s", ENV, e)
                _CFG = None


def effective() -> dict:
    """The effective configuration dict (env-seeded, configure-overridden)."""
    _ensure_env()
    cfg = _CFG
    return dict(cfg) if cfg is not None else dict(DEFAULTS)


def describe() -> dict:
    """Knobs + provenance for ``tools/diagnose.py``."""
    out = effective()
    out["env"] = os.environ.get(ENV, "<unset>")
    return out
