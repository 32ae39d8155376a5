"""Foundation helpers: the error type, dtype names and the worker
rendezvous.

Counterpart of ``mxnet_tpu/base.py``. The port keeps its own copy of the
pieces it needs: ``MXNetError``, dtype canonicalisation (here mapping
MXNet dtype names onto ``torch.dtype`` objects) and
``maybe_init_distributed`` (:285), which joins the worker group of a
``dist_*`` kvstore.
"""
from __future__ import annotations

import datetime
import os

import numpy as _np
import torch

__all__ = ["MXNetError", "did_you_mean", "canonical_dtype", "dtype_name",
           "numpy_dtype",
           "maybe_init_distributed", "HALF_DTYPES"]

# how long a worker waits for the others at the rendezvous
RENDEZVOUS_TIMEOUT_S = 300.0


class MXNetError(RuntimeError):
    """Error raised by the framework (parity: dmlc error -> MXNetError)."""


def did_you_mean(name, candidates, n=1):
    """A ``" (did you mean ...?)"`` suffix for a near-miss name, or ``""``
    (``mxnet_tpu/base.py:22``: the one difflib helper of the naming
    errors, such as a mesh's axis names)."""
    import difflib

    close = difflib.get_close_matches(str(name),
                                      [str(c) for c in candidates], n=n)
    if not close:
        return ""
    if len(close) == 1:
        return f" (did you mean {close[0]!r}?)"
    return f" (did you mean one of {close}?)"


_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
# the half-precision types: multi_precision keeps a float32 master of
# these, and BatchNorm stays float32 when a network is cast to them
HALF_DTYPES = (torch.float16, torch.bfloat16)


def canonical_dtype(dtype) -> torch.dtype:
    """Normalise a dtype-ish value (name, numpy dtype or type, torch
    dtype; None means float32) to a ``torch.dtype``."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise TypeError(f"unsupported dtype {dtype!r}")
        return dtype
    name = dtype if isinstance(dtype, str) else _np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


def dtype_name(dtype) -> str:
    """The MXNet name of a dtype (``"float32"``, ``"bfloat16"``, ...)."""
    return _NAMES[canonical_dtype(dtype)]


def numpy_dtype(dtype):
    """The numpy dtype a host copy of ``dtype`` takes; bfloat16 has no
    numpy type and widens to float32."""
    name = dtype_name(dtype)
    return _np.dtype("float32" if name == "bfloat16" else name)


def maybe_init_distributed():
    """Join the worker group of the ``dist_*`` kvstores and return
    ``(rank, num_workers)``.

    Workers are started with the environment that ``tools/launch.py``
    sets: ``MXTPU_COORDINATOR`` (``host:port`` of rank 0's rendezvous),
    ``MXTPU_NUM_WORKERS`` and ``MXTPU_WORKER_ID``. With more than one
    worker this initialises ``torch.distributed`` with the gloo backend
    over a TCP store at the coordinator (gloo carries CUDA tensors
    through host memory, as MXNet 1.x's parameter server did; NCCL
    refuses two ranks on one card). A group that is already initialised
    is joined as it is. Without ``MXTPU_NUM_WORKERS`` above 1 the group
    is this process alone. A group of several workers that cannot be
    formed (no coordinator given, or none reachable within
    ``RENDEZVOUS_TIMEOUT_S``) raises :class:`MXNetError`; it never
    shrinks to one worker. Called when a ``dist_*`` store is created,
    never at import."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    num = int(os.environ.get("MXTPU_NUM_WORKERS", "1"))
    if num <= 1:
        return 0, 1
    coord = os.environ.get("MXTPU_COORDINATOR")
    rank = int(os.environ.get("MXTPU_WORKER_ID", "0"))
    if not coord:
        raise MXNetError(f"MXTPU_NUM_WORKERS={num} but MXTPU_COORDINATOR is "
                         "not set: a dist kvstore cannot form its group")
    if not dist.is_available():
        raise MXNetError("torch.distributed is not available in this build "
                         "of PyTorch: a dist kvstore cannot form its group")
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}", world_size=num, rank=rank,
            timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    except (RuntimeError, ValueError, OSError) as e:
        raise MXNetError(f"worker {rank} of {num} could not join the group "
                         f"at {coord}: {e}") from e
    return rank, num
