"""Model bus: live weight streaming from a trainer into serving, with
poison rejection and rollback (counterpart of ``mxnet_tpu/modelbus.py``).

A shared-directory pub/sub channel whose files are the JAX package's
format, so either package reads what the other writes:

* **Publisher** -- :meth:`ShardedTrainer.publish_to(bus, every=K)
  <mxnet_tpu_torch.parallel.sharded_trainer.ShardedTrainer.publish_to>`
  writes a version-stamped update record every K steps. Small parameters
  ride as full tensors; large (embedding-table-shaped) ones ride int8
  per-row compressed or as top-k changed rows. A non-finite update is
  never published: the finite gate runs before the record is encoded.
* **Record discipline** -- the payload (one ``.update`` npz) lands
  through the checkpoint module's atomic tmp+fsync+rename write; the
  manifest (``.json``: CRC32, size, a per-parameter shape/dtype census,
  the step) is written after it, so a manifest proves a complete
  payload. Torn manifests are skipped (a warn-once latch and a counter).
* **Subscriber** -- a :class:`BusWatcher` in a serving process validates
  each new version (CRC, census against the live
  :class:`~mxnet_tpu_torch.serving.model.ServedModel`, finiteness) and
  applies it between batches through ``ServedModel.swap_params``, which
  writes the values into the tensors the captured bucket graphs read:
  nothing is captured again. A failing version is **quarantined** (a
  ``reject-v*.json`` record) and the last good version stays served.
* **Rollback** -- re-publication: :meth:`ModelBus.auto_rollback`
  re-publishes the newest good version as a fresh (higher) version once
  the head of the bus is quarantined.

A subscriber is at most ``K * poll`` behind the trainer in steady state
(``BusWatcher.age_steps``). Versions only move forward.

Fault drills: ``modelbus.publish`` fires inside :meth:`ModelBus.publish`
after the finite gate (``nan`` poisons the record's first parameter, the
in-transit corruption the subscriber must reject); ``modelbus.apply``
fires on the subscriber's raw payload bytes (``corrupt`` flips bytes the
CRC check must catch).
"""
from __future__ import annotations

import io
import json
import os
import threading
import time
import weakref
import zlib

import numpy as _np

from . import checkpoint as _checkpoint
from . import faults as _faults
from . import log as _log
from .serving.model import _dtype_str
from .telemetry import flight as _flight

__all__ = ["ModelBus", "BusWatcher", "decode_update", "stats",
           "live_watchers", "DEFAULT_COMPRESS_THRESHOLD",
           "PAYLOAD_SUFFIX", "MANIFEST_SUFFIX"]

_logger = _log.get_logger("mxnet_tpu_torch.modelbus")

PAYLOAD_SUFFIX = ".update"
MANIFEST_SUFFIX = ".json"

# params at or above this many elements ride int8-compressed by default
DEFAULT_COMPRESS_THRESHOLD = 65536

# process-lifetime totals
STATS = {"published": 0, "applied": 0, "rejected": 0, "rollbacks": 0,
         "publish_skipped_nonfinite": 0, "torn_skips": 0,
         "stale_skips": 0}
_stats_lock = threading.Lock()

_WATCHERS = weakref.WeakSet()

# warn-once latch (the kernels-fallback convention): one log line per
# bus directory however many torn records are skipped; the counter
# keeps the true total
_torn_warned = set()


def _bump(key, n=1):
    with _stats_lock:
        STATS[key] = STATS.get(key, 0) + n


def stats():
    """Process-lifetime bus totals."""
    with _stats_lock:
        return dict(STATS)


def live_watchers():
    """BusWatcher instances alive in this process."""
    return list(_WATCHERS)


class _StaleRecord(Exception):
    """A record that cannot be applied YET (sparse base mismatch, payload
    mid-rotation) — skip without quarantining it."""


# ------------------------------------------------------ record encoding ---

def _is_finite(arr):
    return arr.dtype.kind != "f" or bool(_np.isfinite(arr).all())


def _encode_param(arr, encoding, key, out, base=None, k=None):
    """Encode one array into npz entries under `key`; returns the extra
    census fields for the manifest entry."""
    if encoding == "full":
        out[key] = arr
        return {}
    if encoding == "int8_rows":
        rows = arr.reshape(arr.shape[0], -1)
        m = _np.max(_np.abs(rows), axis=1)
        scale = _np.where(m > 0, m / 127.0, 1.0).astype(_np.float32)
        q = _np.rint(rows / scale[:, None])
        bad = ~_np.isfinite(m)
        if bad.any():
            # a row holding NaN or Inf (in-transit poison: the finite gate
            # keeps them out of a publish) keeps a NaN scale, so that the
            # record decodes non-finite and a subscriber rejects it. The
            # JAX package's encoder gives such a row scale 1 and an
            # undefined int8 cast: a finite row of garbage that passes
            # every check. Finite rows encode as there, bit for bit.
            scale[bad] = _np.nan
            q[bad] = 0
        out[key + "_q"] = _np.clip(q, -127, 127).astype(_np.int8)
        out[key + "_s"] = scale
        return {}
    if encoding == "topk_rows":
        delta = _np.linalg.norm(
            (arr - base).reshape(arr.shape[0], -1), axis=1)
        k = min(int(k), arr.shape[0])
        idx = _np.sort(_np.argpartition(delta, -k)[-k:]).astype(_np.int64)
        out[key + "_idx"] = idx
        out[key + "_rows"] = arr[idx]
        return {"rows": int(k)}
    raise ValueError(f"unknown bus encoding {encoding!r}")


def _decode_param(ent, npz, key, base=None):
    dtype = _np.dtype(ent["dtype"])
    shape = tuple(ent["shape"])
    enc = ent["encoding"]
    if enc == "full":
        arr = _np.asarray(npz[key])
    elif enc == "int8_rows":
        q = _np.asarray(npz[key + "_q"])
        scale = _np.asarray(npz[key + "_s"])
        arr = (q.astype(_np.float32) * scale[:, None]).reshape(shape)
    elif enc == "topk_rows":
        if base is None:
            raise ValueError(
                "topk_rows record needs the base parameter values "
                f"(base_version) to decode {ent.get('name')!r}")
        arr = _np.array(base, copy=True)
        arr[_np.asarray(npz[key + "_idx"])] = _np.asarray(
            npz[key + "_rows"])
    else:
        raise ValueError(f"unknown bus encoding {enc!r}")
    if tuple(arr.shape) != shape:
        raise ValueError(
            f"decoded shape {arr.shape} != census shape {shape} for "
            f"{ent.get('name')!r}")
    return arr.astype(dtype, copy=False)


def decode_update(manifest, payload, base_params=None):
    """Decode one bus record into ``(params, aux)`` lists of numpy
    arrays in manifest order. `payload` is the raw ``.update`` bytes or
    an open npz mapping; `base_params` (manifest-ordered current values)
    is required only for ``topk_rows`` entries.

    This is the ONE decode seam: the watcher's compressed-row apply and
    a manual full-tensor apply both pass through it, which is what makes
    them bit-equal by construction (tests/test_modelbus.py asserts it).
    """
    if isinstance(payload, (bytes, bytearray)):
        payload = _np.load(io.BytesIO(bytes(payload)), allow_pickle=False)
    params = []
    for i, ent in enumerate(manifest["params"]):
        base = None
        if ent["encoding"] == "topk_rows":
            if base_params is None:
                raise ValueError(
                    "decode_update: record carries topk_rows entries; "
                    "pass base_params")
            base = base_params[i]
        params.append(_decode_param(ent, payload, f"p{i}", base=base))
    aux = [_decode_param(ent, payload, f"a{i}")
           for i, ent in enumerate(manifest.get("aux", []))]
    return params, aux


# --------------------------------------------------------------- the bus ---

class ModelBus:
    """One shared bus directory: version-stamped update records plus
    their quarantine (reject) files.

    Layout (``v<NNNNNNNN>`` is the zero-padded version)::

        v00000003.update             npz payload (atomic write)
        v00000003.json               manifest, written AFTER the payload
        reject-v00000003-<who>.json  a subscriber's quarantine record

    Multi-writer is not a bus concern: the trainer's writer rank is the
    single publisher (subscribers only write reject files, which are
    per-worker named).
    """

    def __init__(self, directory, compress_threshold=None, keep=8):
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.compress_threshold = (DEFAULT_COMPRESS_THRESHOLD
                                   if compress_threshold is None
                                   else int(compress_threshold))
        self.keep = int(keep) if keep else 0
        self.torn_skips = 0
        # publisher-side memory of the last published (decoded) values —
        # the base the NEXT topk_rows record diffs against
        self._last_vals = {}
        self._last_version = None
        self._rolled_back = set()   # quarantined versions already rolled back

    # ------------------------------------------------------------- paths --
    def _vname(self, version):
        return f"v{int(version):08d}"

    def payload_path(self, version):
        return os.path.join(self.directory,
                            self._vname(version) + PAYLOAD_SUFFIX)

    def manifest_path(self, version):
        return os.path.join(self.directory,
                            self._vname(version) + MANIFEST_SUFFIX)

    def reject_path(self, version, worker):
        worker = "".join(c if c.isalnum() or c in "-_" else "_"
                         for c in str(worker)) or "anon"
        return os.path.join(
            self.directory, f"reject-{self._vname(version)}-{worker}.json")

    # ----------------------------------------------------------- listing --
    def _torn(self, path, err):
        self.torn_skips += 1
        _bump("torn_skips")
        _flight.rec("modelbus.torn_skip", os.path.basename(path))
        if self.directory not in _torn_warned:
            _torn_warned.add(self.directory)
            _logger.warning(
                "model bus %s: skipping torn/partial record %s (%s); "
                "further torn records on this bus are counted "
                "(torn_skips) but not logged again",
                self.directory, os.path.basename(path), err)

    def manifests(self):
        """Readable manifests, ascending by version. Torn/partial
        manifest files are skipped through the warn-once latch."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in sorted(names):
            if not (name.startswith("v") and name.endswith(MANIFEST_SUFFIX)):
                continue
            path = os.path.join(self.directory, name)
            try:
                with open(path) as f:
                    m = json.load(f)
                if not isinstance(m.get("version"), int) \
                        or not isinstance(m.get("params"), list):
                    raise ValueError("manifest missing version/params")
            except (OSError, ValueError) as e:
                self._torn(path, e)
                continue
            out.append(m)
        out.sort(key=lambda m: m["version"])
        return out

    def latest(self):
        """The newest readable manifest, or None."""
        mans = self.manifests()
        return mans[-1] if mans else None

    def versions(self):
        """Every version with a record on disk (manifest or payload),
        readable or not — the allocator's collision floor."""
        vs = set()
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        for name in names:
            stem = name
            for suf in (PAYLOAD_SUFFIX, MANIFEST_SUFFIX):
                if stem.endswith(suf):
                    stem = stem[: -len(suf)]
                    break
            if stem.startswith("reject-"):
                stem = stem[len("reject-"):].split("-")[0]
            if stem.startswith("v") and stem[1:].isdigit():
                vs.add(int(stem[1:]))
        return sorted(vs)

    def next_version(self):
        vs = self.versions()
        return (vs[-1] + 1) if vs else 1

    def quarantined(self):
        """Versions any subscriber has rejected (a reject file exists)."""
        out = set()
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if name.startswith("reject-v") and name.endswith(".json"):
                tok = name[len("reject-v"):].split("-")[0].split(".")[0]
                if tok.isdigit():
                    out.add(int(tok))
        return out

    def rejects(self):
        """Every readable reject record, ascending by version -- what the
        publisher acts on."""
        out = []
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in sorted(names):
            if not (name.startswith("reject-v") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                continue
        out.sort(key=lambda r: r.get("version", 0))
        return out

    def write_reject(self, version, reason, worker="", detail=""):
        """Quarantine `version`: an atomic, per-worker reject record."""
        rec = {"version": int(version), "reason": str(reason),
               "detail": str(detail), "worker": str(worker),
               "time": time.time()}
        payload = json.dumps(rec, indent=1, sort_keys=True)

        def writer(tmp):
            with open(tmp, "w") as f:
                f.write(payload)

        _checkpoint.atomic_write(self.reject_path(version, worker), writer)
        return rec

    # ---------------------------------------------------------- publish --
    def publish(self, params, step, aux=(), meta=None, model=None,
                encodings=None, topk=None, version=None):
        """Write one update record; returns its version, or None when
        the finite gate refused it.

        params / aux : iterables of ``(name, array)`` in serving order.
        encodings : optional {name: "full"|"int8_rows"|"topk_rows"}
            overriding the size-based default.
        topk : optional {name: k} — publish only the k most-changed rows
            vs the previous publish (falls back to full/int8 when there
            is no previous publish to diff against).
        """
        named = [(str(n), _np.asarray(a)) for n, a in params]
        aux_named = [(str(n), _np.asarray(a)) for n, a in aux]

        # the finite gate: a NaN/Inf update is NEVER published — the
        # nan-guard's job upstream, re-checked here so a bus can't carry
        # divergence into a fleet even when the guard is off
        for n, a in named + aux_named:
            if not _is_finite(a):
                _bump("publish_skipped_nonfinite")
                _flight.rec("modelbus.skip_nonfinite", n,
                            f"step={int(step)}")
                _logger.warning(
                    "model bus %s: NOT publishing step %d — parameter "
                    "%r is non-finite", self.directory, int(step), n)
                return None

        # injection AFTER the gate = in-transit poison: the subscriber's
        # validation, not the publisher's gate, must catch it (nan mode
        # poisons the record's first parameter)
        if named:
            n0, a0 = named[0]
            named[0] = (n0, _np.asarray(
                _faults.point("modelbus.publish", a0)))
        else:
            _faults.point("modelbus.publish")

        if version is None:
            version = self.next_version()
        version = int(version)
        base_version = None
        out, census_p, census_a = {}, [], []
        decoded_vals = {}
        for i, (n, a) in enumerate(named):
            enc = (encodings or {}).get(n)
            base = self._last_vals.get(n) if topk and n in (topk or {}) \
                else None
            if enc is None:
                if topk and n in topk and base is not None \
                        and base.shape == a.shape:
                    enc = "topk_rows"
                elif (a.size >= self.compress_threshold and a.ndim >= 2
                        and a.dtype.kind == "f"):
                    enc = "int8_rows"
                else:
                    enc = "full"
            if enc == "topk_rows" and (base is None
                                       or base.shape != a.shape):
                enc = "full"   # nothing to diff against yet
            ent = {"name": n, "shape": list(a.shape),
                   "dtype": str(a.dtype), "encoding": enc}
            ent.update(_encode_param(a, enc, f"p{i}", out, base=base,
                                     k=(topk or {}).get(n)))
            if enc == "topk_rows":
                base_version = self._last_version
            census_p.append(ent)
        for i, (n, a) in enumerate(aux_named):
            census_a.append({"name": n, "shape": list(a.shape),
                             "dtype": str(a.dtype), "encoding": "full"})
            out[f"a{i}"] = a

        def writer(tmp):
            with open(tmp, "wb") as f:
                _np.savez(f, **out)

        crc, size = _checkpoint.atomic_write(
            self.payload_path(version), writer)
        manifest = {"version": version, "step": int(step),
                    "time": time.time(),
                    "file": os.path.basename(self.payload_path(version)),
                    "crc32": int(crc), "size": int(size),
                    "params": census_p, "aux": census_a,
                    "base_version": base_version,
                    "model": model, "meta": dict(meta or {}),
                    "publisher": {"pid": os.getpid()}}
        mpayload = json.dumps(manifest, indent=1, sort_keys=True)

        def mwriter(tmp):
            with open(tmp, "w") as f:
                f.write(mpayload)

        _checkpoint.atomic_write(self.manifest_path(version), mwriter)
        _bump("published")
        _flight.rec("modelbus.publish", str(version), f"step={int(step)}")

        # remember the decoded (as-a-subscriber-sees-them) values so the
        # next topk publish diffs against what subscribers actually hold
        for i, (n, _a) in enumerate(named):
            decoded_vals[n] = _decode_param(
                census_p[i], out, f"p{i}", base=self._last_vals.get(n))
        self._last_vals.update(decoded_vals)
        self._last_version = version
        self._rotate()
        return version

    def _rotate(self):
        if not self.keep:
            return
        mans = self.manifests()
        for m in mans[:-self.keep] if len(mans) > self.keep else []:
            for path in (self.payload_path(m["version"]),
                         self.manifest_path(m["version"])):
                try:
                    os.remove(path)
                except OSError:
                    pass

    # --------------------------------------------------- read / rollback --
    def read(self, version, verify=True):
        """``(manifest, payload bytes)`` for one version; `verify`
        checks size+CRC against the manifest (ValueError on mismatch)."""
        with open(self.manifest_path(version)) as f:
            # manifests are atomic_write-published and immutable per
            # version; a vanished (rotated) file raises OSError to the
            # caller by contract, never a torn parse
            manifest = json.load(f)  # concur: torn-ok
        with open(self.payload_path(version), "rb") as f:
            blob = f.read()
        if verify and (len(blob) != manifest["size"] or
                       (zlib.crc32(blob) & 0xFFFFFFFF)
                       != manifest["crc32"]):
            raise ValueError(
                f"bus record v{version} payload fails CRC/size "
                "verification")
        return manifest, blob

    def auto_rollback(self, worker=""):
        """Rollback = re-publish: when the newest version on the bus is
        quarantined, re-publish the newest GOOD (non-quarantined,
        self-contained) version as a fresh higher version so every
        subscriber converges back onto known-good weights. Returns the
        new version, or None when no rollback was needed/possible.
        Idempotent: each quarantined head triggers at most one
        re-publication per bus handle."""
        mans = self.manifests()
        if not mans:
            return None
        q = self.quarantined()
        head = mans[-1]
        if head["version"] not in q \
                or head["version"] in self._rolled_back:
            return None
        good = [m for m in mans
                if m["version"] not in q
                and m.get("base_version") is None]
        if not good:
            self._rolled_back.add(head["version"])
            _logger.warning(
                "model bus %s: head version %d is quarantined but no "
                "good version remains to roll back to",
                self.directory, head["version"])
            return None
        src = good[-1]
        try:
            manifest, blob = self.read(src["version"])
            params, aux = decode_update(manifest, blob)
        except (OSError, ValueError) as e:
            self._torn(self.payload_path(src["version"]), e)
            return None
        names_p = [e["name"] for e in manifest["params"]]
        names_a = [e["name"] for e in manifest.get("aux", [])]
        new_version = self.publish(
            list(zip(names_p, params)), step=manifest["step"],
            aux=list(zip(names_a, aux)), model=manifest.get("model"),
            encodings={n: "full" for n in names_p},
            meta={"rollback_of": head["version"],
                  "source_version": src["version"]})
        if new_version is None:
            return None
        self._rolled_back.add(head["version"])
        _bump("rollbacks")
        _flight.rec("modelbus.rollback", str(new_version),
                    f"of=v{head['version']} from=v{src['version']}")
        _logger.warning(
            "model bus %s: version %d quarantined (%s); rolled back by "
            "re-publishing good version %d as version %d",
            self.directory, head["version"],
            ", ".join(sorted({r["reason"] for r in self.rejects()
                              if r.get("version") == head["version"]}))
            or "?", src["version"], new_version)
        return new_version

    def describe(self):
        """JSON-able bus summary."""
        mans = self.manifests()
        q = self.quarantined()
        return {"directory": self.directory,
                "versions": [m["version"] for m in mans],
                "latest": mans[-1]["version"] if mans else None,
                "latest_step": mans[-1]["step"] if mans else None,
                "quarantined": sorted(q),
                "rejects": self.rejects(),
                "torn_skips": self.torn_skips,
                "keep": self.keep}

    def __repr__(self):
        return f"ModelBus({self.directory!r})"


# ----------------------------------------------------------- the watcher ---

class BusWatcher:
    """The subscriber half: poll a bus from a serving process, validate
    each new version (CRC → census → finiteness), and flip every census-
    matching :class:`~mxnet_tpu.serving.model.ServedModel` of the bound
    :class:`~mxnet_tpu.serving.server.ModelServer` between batches.

    Validation failures quarantine the version on the bus and keep the
    last good version pinned; the watcher never applies a version twice
    and never moves backwards.
    """

    def __init__(self, server, bus, poll=0.25, worker=None):
        self._server = server
        self.bus = bus if isinstance(bus, ModelBus) else ModelBus(bus)
        self.poll = float(poll)
        self.worker = str(worker or f"pid{os.getpid()}")
        self.applied_version = 0
        self.applied_step = None
        self.applied_total = 0
        self.applied_models = []
        self.latest_version = 0
        self.latest_step = None
        self.rejected = {}          # version -> reason (this watcher's)
        self._stop_evt = threading.Event()
        self._thread = None
        _WATCHERS.add(self)

    # --------------------------------------------------------- lifecycle --
    def start(self):
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"mxtpu-modelbus-{self.worker}")
            self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def _loop(self):
        while not self._stop_evt.is_set():
            try:
                self.poll_once()
            except Exception as e:   # the watcher must never die silently
                _logger.warning("model bus watcher %s: poll failed: %s: "
                                "%s", self.worker, type(e).__name__, e)
            self._stop_evt.wait(self.poll)

    # ------------------------------------------------------------- state --
    def age_steps(self):
        """Bounded-staleness distance: latest published step minus the
        applied step (0 when fully caught up or the bus is empty)."""
        if self.latest_step is None:
            return 0
        return max(0, int(self.latest_step) - int(self.applied_step or 0))

    def stats(self):
        return {"bus_dir": self.bus.directory,
                "worker": self.worker,
                "applied_version": self.applied_version,
                "applied_step": self.applied_step,
                "applied_total": self.applied_total,
                "applied_models": list(self.applied_models),
                "latest_version": self.latest_version,
                "latest_step": self.latest_step,
                "age_steps": self.age_steps(),
                "rejected": dict(self.rejected),
                "torn_skips": self.bus.torn_skips}

    def model_names(self):
        try:
            return [m.name for m in self._server.container]
        except Exception:
            return []

    # ------------------------------------------------------------- apply --
    def poll_once(self):
        """One poll: apply the newest applicable version. Returns the
        version applied, or None."""
        mans = self.bus.manifests()
        if not mans:
            return None
        self.latest_version = mans[-1]["version"]
        self.latest_step = mans[-1].get("step")
        q = self.bus.quarantined()
        cands = [m for m in mans
                 if m["version"] > self.applied_version
                 and m["version"] not in q
                 and m["version"] not in self.rejected]
        for m in reversed(cands):    # newest applicable wins
            try:
                if self._apply(m):
                    return m["version"]
            except _StaleRecord:
                _bump("stale_skips")
                continue
            except Exception as e:
                self._reject(m, "apply_error",
                             f"{type(e).__name__}: {e}")
                continue
        return None

    def _reject(self, manifest, reason, detail=""):
        version = manifest["version"]
        self.rejected[version] = reason
        try:
            self.bus.write_reject(version, reason, worker=self.worker,
                                  detail=detail)
        except OSError as e:
            _logger.warning("model bus watcher %s: could not write "
                            "reject record for v%d: %s", self.worker,
                            version, e)
        _bump("rejected")
        _flight.rec("modelbus.reject", str(version), reason)
        _logger.warning(
            "model bus watcher %s: REJECTED version %d (%s%s) — "
            "quarantined; serving stays pinned at version %d",
            self.worker, version, reason,
            f": {detail}" if detail else "", self.applied_version)
        return False

    def _match(self, model, manifest):
        """Map manifest param positions onto `model`'s params: by name
        when both sides carry a matching name set, positionally when the
        counts + shapes + dtypes line up (gluon auto-prefixes differ
        across processes). Returns ``(p_order, a_order)`` — for model
        position j, take manifest entry ``order[j]`` — or None."""
        praws, araws, _v = model.pinned()
        ents_p, ents_a = manifest["params"], manifest.get("aux", [])
        if len(ents_p) != len(praws) or len(ents_a) != len(araws):
            return None

        def order_for(ents, raws, names):
            if names and all(e.get("name") for e in ents) \
                    and set(names) == {e["name"] for e in ents} \
                    and len(set(names)) == len(names):
                by_name = {e["name"]: i for i, e in enumerate(ents)}
                order = [by_name[n] for n in names]
            else:
                order = list(range(len(ents)))
            for j, raw in enumerate(raws):
                e = ents[order[j]]
                if tuple(e["shape"]) != tuple(raw.shape) \
                        or str(e["dtype"]) != _dtype_str(raw):
                    return None
            return order

        p_order = order_for(ents_p, praws,
                            getattr(model, "param_names", None))
        if p_order is None:
            return None
        a_order = order_for(ents_a, araws,
                            getattr(model, "aux_names", None))
        if a_order is None:
            return None
        return p_order, a_order

    def _apply(self, m):
        version = m["version"]
        try:
            with open(self.bus.payload_path(version), "rb") as f:
                blob = f.read()
        except OSError:
            # payload gone mid-read (rotation) or not yet visible —
            # never happens for a manifest written after it on one
            # filesystem, but a remounted/synced bus can race
            raise _StaleRecord
        # 'modelbus.apply' injection on the raw bytes: corrupt mode
        # flips bits the CRC check below must catch; delay/hang stall
        # the apply path; raise surfaces as an apply_error reject
        blob = _faults.point("modelbus.apply", blob)
        if not isinstance(blob, (bytes, bytearray)) \
                or len(blob) != m["size"] \
                or (zlib.crc32(bytes(blob)) & 0xFFFFFFFF) != m["crc32"]:
            return self._reject(
                m, "crc_mismatch",
                f"payload size/CRC does not match manifest "
                f"(size {len(blob) if blob is not None else 0} vs "
                f"{m['size']})")

        container = getattr(self._server, "container", self._server)
        targets = []
        for model in container:
            orders = self._match(model, m)
            if orders is not None:
                targets.append((model, orders))
        if not targets:
            return self._reject(
                m, "census_mismatch",
                f"no served model matches the record census "
                f"({len(m['params'])} params) — served: "
                f"{[mm.name for mm in container]}")

        if m.get("base_version") is not None \
                and int(m["base_version"]) != int(self.applied_version):
            # sparse rows diff against a base this worker does not hold;
            # wait for a self-contained record instead of quarantining
            raise _StaleRecord

        npz = _np.load(io.BytesIO(bytes(blob)), allow_pickle=False)
        applied_names = []
        swaps = []
        for model, (p_order, a_order) in targets:
            base = None
            if m.get("base_version") is not None:
                host = model._host_values()
                base = [None] * len(m["params"])
                for j, src in enumerate(p_order):
                    base[src] = host[j]
            params, aux = decode_update(m, npz, base_params=base)
            for ent, arr in zip(m["params"] + m.get("aux", []),
                                params + aux):
                if not _is_finite(arr):
                    return self._reject(
                        m, "nonfinite",
                        f"decoded parameter {ent.get('name')!r} "
                        "contains NaN/Inf")
            swaps.append((model,
                          [params[src] for src in p_order],
                          [aux[src] for src in a_order]))
        # validation done for EVERY target -- now flip them all; each
        # model's flip runs between two of its batches, so a batch sees
        # exactly one consistent (params, version) pair
        for model, praws, araws in swaps:
            model.swap_params(praws, version, aux_raws=araws)
            applied_names.append(model.name)
        self.applied_version = version
        self.applied_step = m.get("step")
        self.applied_models = applied_names
        self.applied_total += 1
        _bump("applied")
        _flight.rec("modelbus.apply", str(version),
                    f"step={m.get('step')} models={len(applied_names)}")
        _logger.info("model bus watcher %s: applied version %d "
                     "(step %s) to %s", self.worker, version,
                     m.get("step"), applied_names)
        return True
