"""Build the CUDA kernels of ``mxnet_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain ``extern "C"`` interface, loaded with ``ctypes``.
Libraries go to ``build/mxnet_tpu_torch/`` beside the package, named by
a hash of the sources and flags, so a changed source is rebuilt at its
next use and an unchanged one is loaded as it is. ``build_all`` starts
one ``nvcc`` per source, all at once. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..base import MXNetError

__all__ = ["build_all", "library", "sources", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mxnet_tpu_torch"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 900

_lock = threading.Lock()
_libs: dict = {}


def sources():
    """``{name: path}`` of every kernel source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise MXNetError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                     "the CUDA kernels cannot be built on this host")


def _target(name, src):
    h = hashlib.sha256()
    h.update(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=None, force=False):
    """Compile the named kernels (default: all) in parallel, skipping
    those already built unless ``force``. Returns ``{name: {"path",
    "seconds", "ptxas", "built"}}``; ``ptxas`` is nvcc's register and
    shared-memory report. Raises on any failed compile."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, running = {}, []
    for name in names:
        so = _target(name, srcs[name])
        log = so.with_suffix(".log")
        if so.exists() and not force:
            report[name] = {"path": str(so), "seconds": 0.0, "built": False,
                            "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(srcs[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, so, log, tmp, proc, time.perf_counter()))
    for name, so, log, tmp, proc, t0 in running:
        try:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise MXNetError(f"nvcc {name}: no result in {NVCC_TIMEOUT_S}s")
        if proc.returncode != 0:
            raise MXNetError(f"nvcc {name} failed ({proc.returncode}):\n{out}")
        log.write_text(out)
        os.replace(tmp, so)
        report[name] = {"path": str(so), "built": True, "ptxas": out,
                        "seconds": time.perf_counter() - t0}
    return report


def library(name) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]["path"]
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
