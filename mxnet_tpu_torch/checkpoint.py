"""Atomic, checksummed, rotating checkpoints.

Counterpart of ``mxnet_tpu/checkpoint.py``:

* **atomic writes**: every file lands through ``tmp + fsync +
  os.replace`` (:func:`atomic_write`), and the directory entry is fsync'd
  too, so a file on disk is the whole old version or the whole new one;
* **a checksummed manifest**: ``MANIFEST.json`` records every
  checkpoint's files with CRC32 and size, and the last good epoch; it is
  written atomically. Its schema is the JAX package's, so either package
  reads the other's manifest;
* **keep-N rotation**: checkpoints beyond ``keep`` leave the manifest and
  their files are deleted;
* **corruption fallback**: :meth:`CheckpointManager.load` verifies the
  checksums and falls back, with a warning naming the corrupt file, to
  the newest checkpoint that verifies;
* **resume**: :meth:`CheckpointManager.resume` returns the latest good
  entry; ``ShardedTrainer.save_checkpoint`` / ``resume`` build on it.

:func:`host_metadata` records torch and CUDA facts where the JAX package
records JAX's. Every :func:`atomic_write` first hits the ``ckpt.write``
fault-injection point (:mod:`mxnet_tpu_torch.faults`, JAX :106).
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
import zlib

from . import faults as _faults

__all__ = ["CheckpointManager", "atomic_write", "crc32_file",
           "MANIFEST_NAME", "host_metadata"]

MANIFEST_NAME = "MANIFEST.json"


def host_metadata():
    """torch and device facts for a MANIFEST entry's ``topology``, so that
    a resume on other software or hardware can be diagnosed. JSON-able;
    a host whose CUDA probe fails still checkpoints."""
    import torch

    meta = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "process_count": 1}
    try:
        if torch.cuda.is_available():
            meta["backend"] = "gpu"
            meta["device_count"] = torch.cuda.device_count()
            meta["device_kind"] = torch.cuda.get_device_name(0)
        else:
            meta["backend"] = "cpu"
            meta["device_count"] = 1
            meta["device_kind"] = "cpu"
    except Exception as e:  # a failed probe must not block a save
        meta["error"] = f"{type(e).__name__}: {e}"
    return meta


def crc32_file(path, chunk=1 << 20):
    """CRC32 of a file's bytes, streamed."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


def _fsync_dir(dirname):
    """fsync a directory entry so that a rename survives power loss;
    best effort, as some filesystems refuse it."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path, writer):
    """Write a file atomically: ``writer(tmp_path)`` writes the payload,
    which reaches ``path`` only through fsync and ``os.replace``. A crash
    at any point leaves the previous content of ``path`` or the whole new
    one (a stray ``*.tmp.*`` sibling may remain after a kill). Returns
    ``(crc32, size)`` of what was written."""
    if _faults.ARMED:
        _faults.point("ckpt.write")
    path = os.fspath(path)
    # the pid and the thread: two threads may write one path at once
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        writer(tmp)
        with open(tmp, "rb+") as f:
            os.fsync(f.fileno())
        crc = crc32_file(tmp)
        size = os.path.getsize(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    _fsync_dir(os.path.dirname(path))
    return crc, size


class CheckpointManager:
    """A directory of rotated, checksummed checkpoints and MANIFEST.json.

    Each checkpoint is one epoch's named files (``<prefix>-<epoch:04d>.
    <name>``), written atomically and recorded with CRC32 and size.
    ``keep`` bounds how many epochs are kept (``None`` or 0: all)."""

    def __init__(self, directory, prefix="ckpt", keep=5):
        self.directory = os.fspath(directory)
        self.prefix = prefix
        self.keep = int(keep) if keep else 0
        os.makedirs(self.directory, exist_ok=True)
        self._manifest = self._load_manifest()

    @property
    def manifest_path(self):
        return os.path.join(self.directory, MANIFEST_NAME)

    def _load_manifest(self):
        try:
            with open(self.manifest_path) as f:
                m = json.load(f)
            if not isinstance(m.get("checkpoints"), list):
                raise ValueError("manifest has no checkpoint list")
            return m
        except FileNotFoundError:
            pass
        except (ValueError, OSError) as e:
            # a torn manifest starts a fresh one: the old checkpoints'
            # integrity can no longer be vouched for
            warnings.warn(f"corrupt checkpoint manifest "
                          f"{self.manifest_path}: {e}; starting fresh",
                          stacklevel=3)
        return {"version": 1, "prefix": self.prefix, "checkpoints": [],
                "last_good": None}

    def _write_manifest(self):
        payload = json.dumps(self._manifest, indent=1, sort_keys=True)

        def writer(tmp):
            with open(tmp, "w") as f:
                f.write(payload)

        atomic_write(self.manifest_path, writer)

    def _path(self, entry_file):
        return os.path.join(self.directory, entry_file)

    def save(self, epoch, files, step=None, meta=None):
        """Write one checkpoint atomically and record it as the last good
        one. ``files``: ``{name: writer}``, where ``writer(path)`` writes
        that file, or ``bytes`` written as they are. Returns ``{name:
        path}``."""
        epoch = int(epoch)
        entry = {"epoch": epoch, "step": None if step is None else int(step),
                 "time": time.time(), "meta": dict(meta or {}), "files": {}}
        for name, writer in files.items():
            fname = f"{self.prefix}-{epoch:04d}.{name}"
            if isinstance(writer, (bytes, bytearray)):
                data = bytes(writer)

                def writer(tmp, _d=data):
                    with open(tmp, "wb") as f:
                        f.write(_d)
            crc, size = atomic_write(self._path(fname), writer)
            entry["files"][name] = {"file": fname, "crc32": crc,
                                    "size": size}
        cps = [e for e in self._manifest["checkpoints"]
               if e["epoch"] != epoch]
        cps.append(entry)
        cps.sort(key=lambda e: e["epoch"])
        self._manifest["checkpoints"] = cps
        self._manifest["last_good"] = epoch
        self._rotate()
        self._write_manifest()
        return {name: self._path(fi["file"])
                for name, fi in entry["files"].items()}

    def _rotate(self):
        if not self.keep:
            return
        cps = self._manifest["checkpoints"]
        drop, self._manifest["checkpoints"] = cps[:-self.keep], \
            cps[-self.keep:]
        kept_files = {fi["file"] for e in self._manifest["checkpoints"]
                      for fi in e["files"].values()}
        for e in drop:
            for fi in e["files"].values():
                if fi["file"] in kept_files:
                    continue
                try:
                    os.remove(self._path(fi["file"]))
                except OSError:
                    pass

    def epochs(self):
        """The recorded epochs, ascending."""
        return [e["epoch"] for e in self._manifest["checkpoints"]]

    def verify(self, entry):
        """Whether every file of ``entry`` exists with its size and CRC."""
        for fi in entry["files"].values():
            path = self._path(fi["file"])
            try:
                if os.path.getsize(path) != fi["size"] or \
                        crc32_file(path) != fi["crc32"]:
                    return False
            except OSError:
                return False
        return True

    def load(self, epoch=None):
        """``(entry, {name: path})`` of the requested (default: newest)
        checkpoint, falling back to the newest earlier one that verifies.
        Raises FileNotFoundError when none is recorded (at or below
        ``epoch``), ValueError when every candidate is corrupt."""
        cands = [e for e in self._manifest["checkpoints"]
                 if epoch is None or e["epoch"] <= int(epoch)]
        if not cands:
            raise FileNotFoundError(
                f"no checkpoint recorded in {self.directory!r}"
                + ("" if epoch is None else f" at or below epoch {epoch}"))
        bad = []
        for entry in reversed(cands):
            if self.verify(entry):
                if bad:
                    warnings.warn(
                        "corrupt checkpoint file(s) "
                        f"{[self._path(b) for b in bad]} failed checksum; "
                        f"falling back to epoch {entry['epoch']}",
                        stacklevel=2)
                return entry, {name: self._path(fi["file"])
                               for name, fi in entry["files"].items()}
            bad.extend(fi["file"] for fi in entry["files"].values())
        raise ValueError(
            f"all {len(cands)} checkpoint(s) in {self.directory!r} failed "
            f"checksum verification: {[self._path(b) for b in bad]}")

    def resume(self):
        """The latest good checkpoint as ``(entry, paths)``, or None when
        none is recorded. If every checkpoint is corrupt this raises:
        restarting a long run from scratch silently is never right."""
        if not self._manifest["checkpoints"]:
            return None
        return self.load()

    @property
    def last_good(self):
        return self._manifest.get("last_good")
