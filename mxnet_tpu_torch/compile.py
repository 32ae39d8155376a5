"""Compile service: one seam for the port's captured forwards.

Counterpart of the in-memory service of ``mxnet_tpu/compile.py``. There,
``jit`` traces a function once per call signature into one XLA
executable; here, on a CUDA card, it captures the function once per
signature into a ``torch.cuda.CUDAGraph`` and replays it, so a forward
of hundreds of ops costs one graph launch instead of one host dispatch
per op. ``CachedOp`` (``hybridize()``) calls it under the site
``"cachedop"`` and ``ServedModel`` under ``"serving"``, one entry per
bucket.

* **Signature.** The pytree structure of the arguments; each tensor's
  shape, dtype and device; every other leaf by value (by ``repr`` when
  it cannot be hashed); and the data pointer, shape and dtype of each
  tensor the function reads beside its arguments (``reads``, a
  callable: a block's parameters, a served model's snapshot).
* **One entry per argument signature**, as the JAX package keeps one
  executable per argument signature. The reads' pointers are stored in
  the entry: a parameter rebound to a new tensor (``set_data``,
  ``cast``, BatchNorm's running statistics after a training forward)
  makes the entry stale, and the next call drops it (its graph and
  memory pool with it) and captures anew in its place; so a
  train-then-evaluate loop holds one graph per input signature, not one
  per evaluation. A parameter written in place (an optimizer step)
  keeps the entry, and the replay reads its new values.
* **Entry on a card.** The arguments are copied into static input
  buffers; the function runs once eagerly on a side stream (lazy
  initialisation: cuBLAS workspaces, kernel attributes, the hand-written
  kernels' libraries), is captured on that stream with
  ``capture_error_mode="thread_local"`` (another thread may launch or
  stage meanwhile; captures themselves take one process-wide lock), and
  is replayed. A call copies its arguments into the static inputs on
  the current stream, replays, and returns fresh copies of the static
  outputs: a caller's earlier result never changes under a later call.
  Each call waits for the previous one's copies to finish, so two
  threads may share an entry.
* **Entry on the CPU.** A plain call of the function: the "plain
  version" of capture, as the kernels' plain versions are of their
  kernels. Keys and statistics are the same.
* **Launch counts.** A replay calls no kernel wrapper. What the wrappers
  counted during the capture (``kernels.recording``) is added to the
  counters at every replay, so ``kernels.launch_counts()`` keeps
  counting the launches that ran on the card.
* **Nesting.** While a jitted function runs (warm-up, capture or a plain
  call), other jitted functions called on the same thread run their
  function plainly into it: a hybridized child inside a captured parent
  is part of the parent's graph.

There is no fallback: a capture that fails raises
:class:`CaptureError`, naming the op that refused, and never runs the
eager forward instead. ``set_enabled(False)`` is the explicit eager
route (the port's reading of ``MXNET_TPU_COMPILE_SERVICE=0``): calls go
straight to the function, with no signature and no accounting.

Not ported, each raising :class:`~mxnet_tpu_torch.base.MXNetError`: the
disk cache (``configure``, ``fingerprint``, ``disk_report``,
``gc_cache``) and the warm-up manifest (``warmup``, ``manifest``,
``save_manifest``, ``clear_manifest``, ``last_warmup``). A CUDA graph
holds device addresses of one process and does not serialize.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
import time
import traceback
import weakref

import torch

from .base import MXNetError

__all__ = ["jit", "stats", "totals", "reset_stats", "set_enabled",
           "enabled", "clear_memory", "registered", "inside", "nested",
           "cache_dir", "configure", "fingerprint", "warmup", "manifest",
           "save_manifest", "clear_manifest", "last_warmup", "disk_report",
           "gc_cache", "CaptureError"]

_lock = threading.RLock()
# the statistics' read-modify-writes (runner threads of several models
# count at once)
_stats_lock = threading.Lock()
# one capture at a time in the process (a capture's warm-up, begin and
# end; replays and eager work of other threads go on meanwhile)
_capture_lock = threading.Lock()
_ENABLED = True
# site -> [hits, misses, compiles, compile_ms, captures, capture_ms,
#          replays]
_SITES: dict = {}
_REGISTRY: dict = {}  # token key -> weakref(ServiceFunction)
_tls = threading.local()


class CaptureError(MXNetError, RuntimeError):
    """A forward could not be captured into a CUDA graph."""


# ------------------------------------------------------------- lifecycle ---

def enabled() -> bool:
    return _ENABLED


def set_enabled(on) -> bool:
    """Turn capture on or off for the whole process; returns the previous
    state. Off, every jitted function runs eagerly, uncounted."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


def inside() -> bool:
    """Whether this thread is running a jitted function's body."""
    return getattr(_tls, "depth", 0) > 0


@contextlib.contextmanager
def nested():
    """Mark this thread as inside a jitted function's body: jitted
    functions and hybridized blocks called within run plainly."""
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


def _not_ported(name):
    raise MXNetError(f"compile.{name} is not ported: a CUDA graph does not "
                     "serialize (it holds one process's device addresses), "
                     "so the port has no disk cache and no warm-up "
                     "manifest; ServedModel.warmup captures every bucket "
                     "in process")


def cache_dir():
    """The on-disk cache root: always None (memory only)."""
    return None


def configure(cache_dir="__env__"):
    _not_ported("configure")


def fingerprint():
    _not_ported("fingerprint")


def warmup(source=None):
    _not_ported("warmup")


def manifest():
    _not_ported("manifest")


def save_manifest(path):
    _not_ported("save_manifest")


def clear_manifest():
    _not_ported("clear_manifest")


def last_warmup():
    _not_ported("last_warmup")


def disk_report():
    _not_ported("disk_report")


def gc_cache():
    _not_ported("gc_cache")


# ----------------------------------------------------------- site stats ----

def _site_stats(site):
    with _lock:
        st = _SITES.get(site)
        if st is None:
            st = _SITES[site] = [0, 0, 0, 0.0, 0, 0.0, 0]
        return st


def _as_dict(st):
    return {"hits": st[0], "misses": st[1], "compiles": st[2],
            "compile_ms": st[3], "captures": st[4], "capture_ms": st[5],
            "replays": st[6]}


def stats():
    """Per-site statistics ``{site: {hits, misses, compiles, compile_ms,
    captures, capture_ms, replays}}`` of sites that saw traffic.
    ``misses``: calls that made an entry; ``compiles``: entries made
    (``captures`` of them CUDA graphs); ``compile_ms``: host
    milliseconds spent making them (on a card the eager warm-up, the
    capture and its synchronisation; on the CPU the first plain call);
    ``replays``: graph launches, the first after each capture
    included."""
    return {site: _as_dict(st) for site, st in sorted(_SITES.items())
            if st[0] or st[1]}


def totals():
    """The statistics summed over sites."""
    agg = [0, 0, 0, 0.0, 0, 0.0, 0]
    for st in list(_SITES.values()):
        for i, v in enumerate(st):
            agg[i] += v
    return _as_dict(agg)


def reset_stats():
    """Zero every site's statistics in place (live functions hold their
    site's list)."""
    with _stats_lock:
        for st in _SITES.values():
            st[0] = st[1] = st[2] = st[4] = st[6] = 0
            st[3] = st[5] = 0.0


def clear_memory():
    """Drop every registered function's entries (and with them their
    graphs and memory pools); statistics are kept."""
    with _lock:
        fns = [ref() for ref in _REGISTRY.values()]
    for fn in fns:
        if fn is not None:
            fn.clear()


def registered():
    """Live registered functions as ``{token key: site}``."""
    with _lock:
        items = list(_REGISTRY.items())
    return {key: fn._site for key, ref in items
            if (fn := ref()) is not None}


# ------------------------------------------------------------ pytrees ------

_LEAF = object()


def _flatten(obj, leaves):
    """Structure of ``obj`` with its tensors appended to ``leaves``;
    tuples, lists and dicts are structure, other values static."""
    t = type(obj)
    if t is tuple or t is list:
        return (t, tuple(_flatten(o, leaves) for o in obj))
    if t is dict:
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in obj.items()))
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return _LEAF
    return (None, obj)


def _rebuild(spec, it):
    if spec is _LEAF:
        return next(it)
    kind, body = spec
    if kind is None:
        return body
    if kind is dict:
        return {k: _rebuild(s, it) for k, s in body}
    items = [_rebuild(s, it) for s in body]
    return items if kind is list else tuple(items)


def _sig_node(obj):
    t = type(obj)
    if t is tuple or t is list:
        return (t is tuple, tuple(_sig_node(o) for o in obj))
    if t is dict:
        return ("D", tuple((k, _sig_node(v)) for k, v in obj.items()))
    if isinstance(obj, torch.Tensor):
        return (obj.shape, obj.dtype, obj.device)
    try:
        hash(obj)
        return (t, obj)
    except TypeError:
        return (t, repr(obj))


# ------------------------------------------------------------- failures ----

def _op_names():
    from .ops import registry

    return {fn.__code__: registry.canonical(name)
            for name, fn in registry._REGISTRY.items()
            if hasattr(fn, "__code__")}


def _where(exc):
    """Where ``exc`` (or an exception it replaced) was raised: the
    innermost frame of a registered op (``op 'name' (file:line)``), else
    the innermost frame of the port outside this service, else the
    innermost frame."""
    ops, found = _op_names(), {}
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        for frame, line in traceback.walk_tb(exc.__traceback__):
            code = frame.f_code
            path = code.co_filename.replace("\\", "/")
            where = f"{path.rsplit('/', 1)[-1]}:{line}"
            if "/mxnet_tpu_torch/" in path:
                where = path[path.rindex("/mxnet_tpu_torch/") + 1:] + \
                    f":{line}"
            if code in ops:
                found["op"] = f"op {ops[code]!r} ({where})"
            elif "/mxnet_tpu_torch/" in path and not path.endswith(
                    ("/compile.py", "/cached_op.py")):
                found["port"] = f"{code.co_name} ({where})"
            else:
                found["any"] = f"{code.co_name} ({where})"
        exc = exc.__context__ or exc.__cause__
    return found.get("op") or found.get("port") or found.get(
        "any", "an unknown place")


# --------------------------------------------------------------- entries ---

class _Plain:
    """A CPU entry: the function called plainly."""

    kind = "plain"

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, args):
        with nested():
            return self._fn(*args)


_streams = threading.local()


def _capture_stream(device):
    """This thread's capture stream on ``device`` (one per thread and
    card, so cuBLAS keeps one workspace for it)."""
    table = getattr(_streams, "table", None)
    if table is None:
        table = _streams.table = {}
    s = table.get(device)
    if s is None:
        s = table[device] = torch.cuda.Stream(device)
    return s


class _Graph:
    """A card entry: the function captured into a CUDA graph over static
    input and output buffers."""

    kind = "graph"

    def __init__(self, fn, args, device, what):
        from . import kernels

        self.device = device
        leaves = []
        spec = _flatten(args, leaves)
        cur = torch.cuda.current_stream(device)
        # normal tensors, so that calls outside inference mode may write
        # them too
        with torch.inference_mode(False):
            self._static_in = [torch.empty(t.shape, dtype=t.dtype,
                                           device=t.device) for t in leaves]
        with torch.no_grad():
            for s, t in zip(self._static_in, leaves):
                s.copy_(t)
        stream = _capture_stream(device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream), torch.no_grad(), nested():
            fn(*_rebuild(spec, iter(self._static_in)))
        cur.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        try:
            with kernels.recording() as counts, torch.no_grad(), nested(), \
                    torch.cuda.graph(graph, stream=stream,
                                     capture_error_mode="thread_local"):
                out = fn(*_rebuild(spec, iter(self._static_in)))
        except Exception as e:
            raise CaptureError(
                f"{what}: the CUDA graph capture failed in {_where(e)}: "
                f"{type(e).__name__}: {e}") from e
        out_leaves = []
        self._out_spec = _flatten(out, out_leaves)
        self._static_out = out_leaves
        self._counts = dict(counts)
        self._graph = graph
        self._done = torch.cuda.Event()
        self._recorded = False
        self._lock = threading.Lock()

    def __call__(self, args):
        from . import kernels

        leaves = []
        _flatten(args, leaves)
        with self._lock, torch.no_grad():
            cur = torch.cuda.current_stream(self.device)
            if self._recorded:  # the previous call's copies are done
                cur.wait_event(self._done)
            for s, t in zip(self._static_in, leaves):
                s.copy_(t)
            self._graph.replay()
            outs = [o.clone() for o in self._static_out]
            self._done.record(cur)
            self._recorded = True
        kernels.add_counts(self._counts)
        return _rebuild(self._out_spec, iter(outs))


def _device_of(tensors):
    for t in tensors:
        if t.device.type == "cuda":
            return t.device
    return None


# --------------------------------------------------------------- service ---

class ServiceFunction:
    """A callable owned by the service: one entry per call signature."""

    def __init__(self, fn, site, token_key, reads):
        self._fn = fn
        self._site = site
        self._token_key = token_key
        self._reads = reads
        self._st = _site_stats(site)
        # this function's own statistics (as its site's) and its
        # entries' build records
        self._own = [0, 0, 0, 0.0, 0, 0.0, 0]
        self._seen = {}  # argument signature -> entry
        self._miss_lock = threading.Lock()
        self.__name__ = getattr(fn, "__qualname__", None) or getattr(
            fn, "__name__", site)
        with _lock:
            _REGISTRY[token_key] = weakref.ref(self)

    def _count(self, i, n=1):
        with _stats_lock:
            self._st[i] += n
            self._own[i] += n

    def __call__(self, *args):
        if not _ENABLED or inside():
            with nested():
                return self._fn(*args)
        reads = self._reads() if self._reads is not None else ()
        sig = _sig_node(args)
        rkey = tuple((t.data_ptr(), t.shape, t.dtype) for t in reads)
        entry = self._fresh(sig, rkey)
        if entry is None:
            with self._miss_lock:
                entry = self._fresh(sig, rkey)
                if entry is None:
                    return self._miss(sig, rkey, args, reads)
        self._count(0)
        return self._run(entry, args)

    def _fresh(self, sig, rkey):
        """The entry of ``sig`` if it was built over the same reads."""
        entry = self._seen.get(sig)
        return entry if entry is not None and entry.reads == rkey else None

    def _run(self, entry, args):
        if entry.kind == "graph":
            self._count(6)
        return entry(args)

    def _miss(self, sig, rkey, args, reads):
        """Make the entry for ``sig`` over the reads ``rkey`` and run it
        on ``args`` (the first call on the CPU, the first replay on a
        card). A stale entry of ``sig`` is dropped first, so that the
        capture (which empties the allocator's cache) frees its pool."""
        self._count(1)
        self._seen.pop(sig, None)
        leaves = []
        _flatten(args, leaves)
        device = _device_of(leaves) or _device_of(reads)
        t0 = time.perf_counter()
        if device is None:
            entry = _Plain(self._fn)
            out = entry(args)
        else:
            with _capture_lock:
                entry = _Graph(self._fn, args, device,
                               f"{self._site}[{self.__name__}]")
        ms = (time.perf_counter() - t0) * 1e3
        self._count(2)
        self._count(3, ms)
        if device is not None:
            self._count(4)
            self._count(5, ms)
        entry.reads = rkey
        entry.record = {"kind": entry.kind, "ms": ms,
                        "shapes": [tuple(t.shape) for t in leaves]}
        self._seen[sig] = entry
        return out if device is None else self._run(entry, args)

    def stats(self):
        """This function's statistics (as :func:`stats` per site) and
        each live entry's ``{kind, ms, shapes}`` (its input shapes)."""
        return dict(_as_dict(self._own), entries=[
            dict(e.record) for e in list(self._seen.values())])

    def clear(self):
        """Drop every entry (the next call per signature builds anew)."""
        with self._miss_lock:
            self._seen.clear()

    def __repr__(self):
        return f"ServiceFunction({self._site}:{self.__name__})"


def _token_key(site, token):
    return site + "|" + hashlib.sha1(repr(token).encode()).hexdigest()[:20]


def jit(fn, *, site, token, reads=None):
    """The port's counterpart of ``mxnet_tpu.compile.jit``.

    fn : a function of tensors (in tuples, lists and dicts; other
        arguments are static and part of the key) returning tensors in
        such a structure.
    site : metric bucket, ``"cachedop"`` or ``"serving"``.
    token : the function's identity (hashable); one registry entry per
        token.
    reads : None, or a callable returning the tensors ``fn`` reads
        beside its arguments; an entry holds their data pointers, shapes
        and dtypes, and is built anew when they change.
    """
    return ServiceFunction(fn, site, _token_key(site, token), reads)
