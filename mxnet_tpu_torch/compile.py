"""Compile service: one seam for the port's captured forwards and steps.

Counterpart of the in-memory service of ``mxnet_tpu/compile.py``. There,
``jit`` traces a function once per call signature into one XLA
executable; here, on a CUDA card, it captures the function once per
signature into ``torch.cuda.CUDAGraph``s and replays them, so a forward
or a training step of hundreds of ops costs one graph launch instead of
one host dispatch per op. Sites: ``"cachedop"`` (``hybridize()``: the
inference forward, and the forward/backward pair under
``autograd.record()`` or in training mode), ``"serving"``
(``ServedModel``, one entry per bucket), ``"trainer"``
(``ShardedTrainer``: the whole step, and ``predict``) and
``"executor"`` (``Executor``: the training pair and the inference
forward of ``Module``).

* **Signature.** The pytree structure of the arguments; each tensor's
  shape, dtype, device and whether it requires grad; every other leaf
  by value (by ``repr`` when it cannot be hashed); and the data pointer,
  shape, dtype and grad requirement of each tensor the function reads
  beside its arguments (``reads``, a callable: a block's parameters, a
  trainer's weights and optimizer state, an executor's bound arrays).
* **One entry per argument signature**, as the JAX package keeps one
  executable per argument signature. The reads' pointers are stored in
  the entry: a tensor rebound to a new one (``set_data``, ``cast``)
  makes the entry stale, and the next call drops it (its graphs and
  memory pool with it) and captures anew in its place; so a loop holds
  one graph per input signature. A tensor written in place (an
  optimizer step, BatchNorm's running statistics) keeps the entry, and
  the replay reads its new values.
* **Backend flags.** The entry also holds the flags that choose the
  kernels a capture bakes in (cuDNN's ``deterministic``, ``benchmark``
  and ``allow_tf32``; cuBLAS's ``allow_tf32`` and reduced-precision
  reductions; ``torch.use_deterministic_algorithms``): a change of
  flags makes the entry stale, as a rebound read does, and the next
  call captures anew under the new flags. So does AMP's generation
  (``_amp_core.GEN``, moved by ``amp.init`` and ``amp.turn_off``): a
  graph holds the casts of the precision it was captured under.
* **Two kinds of entry on a card** (``jit(kind=...)``), each made by a
  first call that runs the function for real, eagerly on this thread's
  capture stream (lazy initialisation: cuBLAS workspaces, kernel
  attributes, the hand-written kernels' libraries and tables), and
  returns its result:

  - ``"forward"``, a function run by one graph: an inference forward,
    or a training step that writes its state in place. After the first
    call the function is captured over static input buffers, which
    executes nothing; each later call copies its arguments in, replays
    and returns fresh copies of the static outputs, so a caller's
    earlier result never changes under a later call, and N calls of a
    step apply N steps. The first call and the capture run under
    ``no_grad``: a body that differentiates opens its own scope
    (``autograd.record()``).
  - ``"pair"``, a function called under ``autograd.record()``: the
    second call captures a forward graph and a backward graph
    (``torch.autograd.grad`` of the outputs with respect to the
    differentiable arguments and reads, from static output gradients)
    on one memory pool, so the forward's residuals stay in the pool for
    the backward, as in ``torch.cuda.make_graphed_callables``. Each
    call from the second on is one ``autograd.Function`` whose forward
    replays the forward graph and whose backward replays the backward
    graph. It hands autograd copies of its static gradients for the
    arguments, and its static gradients for the reads (a parameter's,
    which ``autograd.backward`` copies into the gradient buffer and
    ``autograd.grad`` copies out: :func:`holds`), so a gradient a
    caller gets never changes under a later replay. The pair is
    differentiable once: a backward with ``create_graph=True`` through
    it raises ``NotImplementedError``, as the JAX package does for a
    hybridized node. A call made while an earlier replayed forward's
    backward is still due (a block called twice under one
    ``record()``) runs eagerly on the caller's stream, since the pool
    holds one forward's residuals, and is counted under ``eager`` in
    :func:`stats`.

  Each graph registers the device's ``mx.random`` generator
  (``CUDAGraph.register_generator_state``), so a replayed Dropout draws
  anew, and ``mx.random.seed`` repeats the draws. The first calls and
  the captures of all threads take one lock (``_capture_lock``), so no
  thread's eager first call runs while another thread captures. Each
  replay waits for the previous one's copies to finish, so two threads
  may share an entry.
* **Entry on the CPU.** A plain call of the function: the "plain
  version" of capture, as the kernels' plain versions are of their
  kernels. Keys and statistics are the same.
* **Launch counts.** A replay calls no kernel wrapper. What the wrappers
  counted during a capture (``kernels.recording``, on the capturing
  thread and on the capture stream: the backward runs on autograd's
  thread) is added to the counters at every replay, so
  ``kernels.launch_counts()`` keeps counting the launches that ran on
  the card. The buffers the captured kernels read (``kernels.keep``:
  the optimizer kernels' tables) live as long as the graph, and a
  table a kernel first meets inside a capture is uploaded when the
  capture ends (``kernels.after_capture``).
* **Nesting.** While a jitted function runs (first call, capture or a plain
  call), other jitted functions called on the same thread run their
  function plainly into it: a hybridized child inside a captured parent
  is part of the parent's graph, and so is a hybridized network inside
  a trainer's step.

* **Costs.** With telemetry on, the call that makes an entry (the eager
  first call on a card, the first plain call on the CPU) runs under
  ``telemetry.costs.counting``: its flops (aten products, and the
  hand-written kernels' formulas, so the CPU and the card count the
  same) go to ``telemetry.costs.record_executable`` under the function's
  token, with the bytes the capture's private memory pool took
  (``temp_bytes``; the allocator's reserved bytes across the capture) in
  the entry's record (``pool_bytes`` in :meth:`ServiceFunction.stats`).
  A pair's first call is its forward alone: its record counts the
  forward's flops. ``ShardedTrainer.step_report`` reads a step's flops
  from there (``costs.flops_for``); a replay's are its capture's.

* **Host ops.** A body that calls a host op (``Custom``, a library op
  of ``mx.library.load``, ``linalg_syevd``: ``ops/registry.py``) waits
  on the host in the middle of its work, which a CUDA graph cannot
  hold. The service decides before any capture that such a body runs
  uncaptured, from the body's first call, which runs eagerly in any case
  (a symbol graph, a hybridized block or a trainer's step has no branch
  that call could miss) and notes every host op it calls
  (``registry.watching_host_ops``). Such an entry calls the function
  plainly at every call, on the card as on the CPU, and each call
  counts under its reason in :func:`stats` (``uncaptured``:
  ``{reason: calls}``). Whether to capture the segments between host
  ops is left open (``ROADMAP.md``).

There is no fallback: a capture that fails raises
:class:`CaptureError`, naming the op that refused, and never runs the
eager function instead. ``set_enabled(False)`` is the explicit eager
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
import gc
import hashlib
import threading
import time
import traceback
import weakref

import torch

from . import _amp_core
from . import profiler as _profiler
from .base import MXNetError

__all__ = ["jit", "stats", "totals", "reset_stats", "set_enabled",
           "enabled", "clear_memory", "registered", "inside", "nested",
           "holds",
           "cache_dir", "configure", "fingerprint", "warmup", "manifest",
           "save_manifest", "clear_manifest", "last_warmup", "disk_report",
           "gc_cache", "CaptureError"]

_lock = threading.RLock()
# the statistics' read-modify-writes (runner threads of several models
# count at once)
_stats_lock = threading.Lock()
# one capture at a time in the process (an entry's eager first call, the
# capture's begin and end; replays and other eager work go on meanwhile)
_capture_lock = threading.Lock()
_ENABLED = True
# site -> [hits, misses, compiles, compile_ms, captures, capture_ms,
#          replays, eager]
_SITES: dict = {}
_UNCAPTURED: dict = {}  # site -> {reason: calls run uncaptured}
_REGISTRY: dict = {}  # token key -> weakref(ServiceFunction)
_tls = threading.local()
# CUDA graph captures open in the process (any thread): the watchdog's
# monitor and bundle writer make no CUDA call while one is
_CAPTURES = 0


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


def capturing() -> bool:
    """Whether a CUDA graph capture is open in this process (one global
    read; ``torch.cuda.is_current_stream_capturing`` sees one stream)."""
    return _CAPTURES > 0


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
            st = _SITES[site] = _zeros()
        return st


def _zeros():
    return [0, 0, 0, 0.0, 0, 0.0, 0, 0]


def _as_dict(st):
    return {"hits": st[0], "misses": st[1], "compiles": st[2],
            "compile_ms": st[3], "captures": st[4], "capture_ms": st[5],
            "replays": st[6], "eager": st[7]}


def stats():
    """Per-site statistics ``{site: {hits, misses, compiles, compile_ms,
    captures, capture_ms, replays, eager}}`` of sites that saw traffic.
    ``misses``: calls that made an entry; ``compiles``: entries made
    (``captures`` of them CUDA graphs); ``compile_ms``: host
    milliseconds spent making them (on a card the eager first call, the
    capture and its synchronisation; on the CPU the first plain call);
    ``replays``: graph launches; ``eager``: hits that ran eagerly (a
    pair called again while its replayed forward's backward was due);
    ``uncaptured``: ``{reason: calls}`` of entries that run their
    function plainly by the host-op rule (the module's docstring)."""
    return {site: dict(_as_dict(st),
                       uncaptured=dict(_UNCAPTURED.get(site, {})))
            for site, st in sorted(_SITES.items()) if st[0] or st[1]}


def totals():
    """The statistics summed over sites."""
    agg = _zeros()
    for st in list(_SITES.values()):
        for i, v in enumerate(st):
            agg[i] += v
    return _as_dict(agg)


def reset_stats():
    """Zero every site's statistics in place (live functions hold their
    site's list)."""
    with _stats_lock:
        for st in _SITES.values():
            st[0] = st[1] = st[2] = st[4] = st[6] = st[7] = 0
            st[3] = st[5] = 0.0
        for reasons in _UNCAPTURED.values():
            reasons.clear()


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
        return (obj.shape, obj.dtype, obj.device, obj.requires_grad)
    try:
        hash(obj)
        return (t, obj)
    except TypeError:
        return (t, repr(obj))


# ------------------------------------------------------------- failures ----

def _op_names():
    """``{code object: op name}`` of the registered ops; a code object
    that several ops share (the unary, binary and scalar tables' wrappers)
    names none of them."""
    from .ops import registry

    names = {}
    for name, op in registry._REGISTRY.items():
        fn = getattr(op, "__wrapped__", op)
        if hasattr(fn, "__code__"):
            names.setdefault(fn.__code__, set()).add(registry.canonical(name))
    return {code: ops.pop() for code, ops in names.items() if len(ops) == 1}


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

    def __call__(self, fn, args, reads=()):
        with nested():
            return fn(*args)


class _Host:
    """An entry whose function holds a host op: called plainly at every
    call, on the card as on the CPU, and counted under ``reason``."""

    kind = "host"

    def __init__(self, reason):
        self.reason = reason

    def __call__(self, fn, args, reads=()):
        with nested():
            return fn(*args)


def _host_reason(seen):
    """The reason an entry whose first call ran the host ops ``seen``
    stays uncaptured, or None."""
    return "host op " + ", ".join(seen) if seen else None


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


def _new_graph(device):
    """A CUDA graph with the device's ``mx.random`` generator registered
    (each replay advances its offset by what the capture drew), and the
    state recomputed forwards draw from once there is one
    (``random.recompute_generator``)."""
    from . import random as _random

    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(_random.generator(device))
    again = _random.recompute_generator(device)
    if again is not None:
        graph.register_generator_state(again)
    return graph


@contextlib.contextmanager
def _capturing(graph, stream, what, pool=None):
    """Capture onto ``graph`` on ``stream``; yields the launch-count
    record, whose deferred work (``kernels.after_capture``: a table's
    upload) runs once the capture ends. A failure raises
    :class:`CaptureError` naming the op.

    Python's cyclic garbage collector is off for the capture (the
    ``torch.cuda.graph`` scope collects before it begins): a collection
    mid-capture may free other garbage that holds CUDA graphs or their
    pools, which the CUDA runtime refuses to destroy while a stream
    captures, and the capture would be lost."""
    from . import kernels

    global _CAPTURES
    collecting = gc.isenabled()
    gc.disable()
    _CAPTURES += 1
    try:
        with kernels.recording(stream) as record, nested(), \
                torch.cuda.graph(graph, pool=pool, stream=stream,
                                 capture_error_mode="thread_local"):
            # what the graph's pool takes: the reserved bytes across the
            # capture, from the cache torch.cuda.graph released on entry
            # (a host read of the allocator's counters, no CUDA call)
            reserved = torch.cuda.memory_reserved(stream.device)
            yield record
        record.pool_bytes = torch.cuda.memory_reserved(stream.device) - \
            reserved
        for work in record.after:
            work()
    except CaptureError:
        raise
    except Exception as e:
        raise CaptureError(
            f"{what}: the CUDA graph capture failed in {_where(e)}: "
            f"{type(e).__name__}: {e}") from e
    finally:
        _CAPTURES -= 1
        if collecting:
            gc.enable()


def _static_copies(leaves):
    """Static input buffers holding ``leaves``' values: normal tensors
    (calls outside inference mode may write them too), leaves that
    require grad where the argument does."""
    with torch.inference_mode(False), torch.no_grad():
        out = [torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)
               for t in leaves]
    for s, t in zip(out, leaves):
        if t.requires_grad:
            s.requires_grad_(True)
    return out


def _copy_in(static, leaves):
    with torch.no_grad():
        for s, t in zip(static, leaves):
            s.copy_(t)


def _eager_on(stream, device, fn, args):
    """``fn(*args)`` run plainly on ``stream`` (a warm-up that is a real
    call): ordered after the current stream's work, and its outputs
    handed back to the current stream."""
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream), nested():
        out = fn(*args)
    cur.wait_stream(stream)
    leaves = []
    _flatten(out, leaves)
    for t in leaves:
        t.record_stream(cur)
    return out


class _Replayer:
    """A captured graph over static input and output buffers: a replay
    copies the inputs in, launches the graph and returns fresh copies of
    the outputs; each waits for the previous one's copies, so threads
    may share it."""

    def _ready(self, graph, counts, static_out):
        self._graph = graph
        self._counts = counts
        self._static_out = [t.detach() for t in static_out]
        self._done = torch.cuda.Event()
        self._recorded = False
        self._lock = threading.Lock()

    def _replay(self, leaves):
        """The caller holds ``self._lock``."""
        from . import kernels

        with torch.no_grad():
            cur = torch.cuda.current_stream(self.device)
            if self._recorded:  # the previous call's copies are done
                cur.wait_event(self._done)
            _copy_in(self._static_in, leaves)
            for work in self._counts.before.values():
                work()
            self._graph.replay()
            outs = [o.clone() for o in self._static_out]
            self._done.record(cur)
            self._recorded = True
        kernels.add_counts(self._counts)
        return outs


class _Graph(_Replayer):
    """A card entry of kind ``"forward"``: made by the function's first
    call, run for real (eagerly on the capture stream) and kept in
    ``first``, then captured, which executes nothing; both under
    ``no_grad``."""

    kind = "graph"

    def __init__(self, fn, args, device, what):
        from .ops import registry

        self.device = device
        leaves = []
        spec = _flatten(args, leaves)
        self._static_in = _static_copies(leaves)
        stream = _capture_stream(device)
        with torch.no_grad():
            with registry.watching_host_ops() as seen, _counting() as cost:
                self.first = _eager_on(stream, device, fn,
                                       _rebuild(spec, iter(self._static_in)))
            self.cost = cost
            # a body that called a host op is not captured (_Host)
            self.host = _host_reason(seen)
            if self.host is not None:
                return
            # after the first call, which may make the generator state a
            # recomputation draws from (it is registered from then on)
            graph = _new_graph(device)
            with _capturing(graph, stream, what) as counts:
                out = fn(*_rebuild(spec, iter(self._static_in)))
        out_leaves = []
        self._out_spec = _flatten(out, out_leaves)
        self._ready(graph, counts, out_leaves)
        self.pool_bytes = counts.pool_bytes

    def __call__(self, fn, args, reads=()):
        leaves = []
        _flatten(args, leaves)
        with self._lock:
            outs = self._replay(leaves)
        return _rebuild(self._out_spec, iter(outs))


class _Due:
    """The mark of one replayed forward of a pair: alive while its
    autograd node is, ``done`` once its backward replayed."""

    __slots__ = ("done", "__weakref__")

    def __init__(self):
        self.done = False


class _PairFunction(torch.autograd.Function):
    """One call of a captured pair: the forward graph replayed in
    ``forward``, the backward graph in ``backward``. Differentiable
    once: the backward graph computes first-order gradients only, so a
    backward with ``create_graph=True`` (run with grad mode on) raises
    rather than hand back gradients cut off from the graph."""

    @staticmethod
    def forward(ctx, pair, due, n_in, *tensors):
        ctx.pair, ctx.due = pair, due
        outs = pair.replay_forward(tensors[:n_in])
        ctx.mark_non_differentiable(*[o for o, req in
                                      zip(outs, pair.out_req) if not req])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                f"{ctx.pair._what}: create_graph=True cannot differentiate "
                "through a captured hybridized call (its backward graph "
                "computes first-order gradients only); run the forward "
                "un-hybridized or with compile.set_enabled(False)")
        return (None, None, None) + ctx.pair.replay_backward(ctx.due, grads)


class _Pair(_Replayer):
    """A card entry of kind ``"pair"``: a forward graph and a backward
    graph on one memory pool, replayed through :class:`_PairFunction`.
    Made eager (the first call), captured at the next call."""

    kind = "pair"

    def __init__(self, device, what, count):
        self.device = device
        self._what = what
        self._count = count  # the owning function's statistics
        self.captured = False
        self._due = None     # weakref to the last replayed forward's mark
        self._lock = threading.Lock()

    def eager(self, fn, args):
        """The function's first call, run plainly on the capture stream
        (the caller holds ``_capture_lock``)."""
        return _eager_on(_capture_stream(self.device), self.device,
                         fn, args)

    def busy(self):
        """Whether a replayed forward's backward is still due."""
        due = self._due() if self._due is not None else None
        return due is not None and not due.done

    def capture(self, fn, args, reads):
        """Capture the forward and the backward of ``fn`` over static
        copies of ``args`` and the differentiable ``reads``; executes
        nothing."""
        leaves = []
        spec = _flatten(args, leaves)
        self._static_in = _static_copies(leaves)
        diff = [s for s in self._static_in if s.requires_grad] + \
            [r for r in reads if r.requires_grad]
        self._arg_req = [t.requires_grad for t in leaves]
        self._n_reads = sum(r.requires_grad for r in reads)
        stream = _capture_stream(self.device)
        fwd = _new_graph(self.device)
        pool = torch.cuda.graph_pool_handle()
        with _capturing(fwd, stream, self._what, pool=pool) as fcounts:
            out = fn(*_rebuild(spec, iter(self._static_in)))
        out_leaves = []
        self._out_spec = _flatten(out, out_leaves)
        self.out_req = [o.requires_grad for o in out_leaves]
        heads = [o for o in out_leaves if o.requires_grad]
        self._cots = [torch.empty_like(o) for o in heads]
        self._bwd, self._grads, bcounts = None, [], {}
        if heads and diff:
            bwd = _new_graph(self.device)
            with _capturing(bwd, stream, self._what + " backward",
                            pool=pool) as bcounts:
                grads = torch.autograd.grad(heads, diff, self._cots,
                                            allow_unused=True)
            self._bwd = bwd
            self._grads = [None if g is None else g.detach() for g in grads]
        self.held = {g.data_ptr() for g in self._grads[sum(self._arg_req):]
                     if g is not None}
        _PAIRS.add(self)
        self._ready(fwd, fcounts, out_leaves)
        self._bcounts = bcounts
        self.pool_bytes = fcounts.pool_bytes + getattr(bcounts,
                                                       "pool_bytes", 0)
        self.captured = True

    def __call__(self, fn, args, reads=()):
        leaves = []
        _flatten(args, leaves)
        due = _Due()
        with self._lock:
            self._due = weakref.ref(due)
        outs = _PairFunction.apply(
            self, due, len(leaves), *leaves,
            *[r for r in reads if r.requires_grad])
        return _rebuild(self._out_spec, iter(outs))

    def replay_forward(self, leaves):
        with self._lock:
            outs = self._replay(leaves)
        self._count(6)
        return outs

    def replay_backward(self, due, grads):
        """The backward graph replayed for the forward marked ``due``:
        gradients for the function's inputs (None where one takes
        none): copies of the graph's static ones for the arguments, the
        static ones themselves for the reads (:func:`holds`)."""
        from . import kernels

        with self._lock:
            if self._due is None or self._due() is not due:
                raise MXNetError(
                    f"{self._what}: the captured forward was replayed "
                    "again before this backward ran, so its saved "
                    "activations are gone (a backward with "
                    "retain_graph=True after a later forward of the same "
                    "block); call backward before the next forward, or "
                    "run this block eagerly (compile.set_enabled(False))")
            if self._bwd is not None:
                with torch.no_grad():
                    heads = [g for g, req in zip(grads, self.out_req) if req]
                    for c, g in zip(self._cots, heads):
                        c.copy_(g)
                    for work in self._bcounts.before.values():
                        work()
                    self._bwd.replay()
            it = iter(self._grads)
            args = tuple(_cloned(next(it)) if req else None
                         for req in self._arg_req)
            due.done = True
        if self._bwd is not None:
            kernels.add_counts(self._bcounts)
            self._count(6)
        return args + tuple(next(it) for _ in range(self._n_reads))


def _flags():
    """The backend flags that choose the kernels a capture bakes in."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
            matmul.allow_tf32, matmul.allow_fp16_reduced_precision_reduction,
            matmul.allow_bf16_reduced_precision_reduction,
            torch.are_deterministic_algorithms_enabled())


def _cloned(t):
    return None if t is None else t.clone()


@contextlib.contextmanager
def _counting():
    """``telemetry.costs.counting()`` with telemetry on; yields the
    :class:`~mxnet_tpu_torch.telemetry.costs.FlopCount`, or None (and
    counts nothing) with telemetry off."""
    from .telemetry import _state, costs

    if not _state.enabled:
        yield None
        return
    with costs.counting() as count:
        yield count


def _device_of(tensors):
    for t in tensors:
        if t.device.type == "cuda":
            return t.device
    return None


# --------------------------------------------------------------- service ---

_PAIRS = weakref.WeakSet()  # captured pairs


def holds(tensor):
    """Whether ``tensor`` is a captured pair's static gradient of a read
    (a buffer its next replayed backward overwrites): a caller keeping
    it must copy it."""
    ptr = tensor.data_ptr()
    return any(ptr in pair.held for pair in list(_PAIRS))


_KINDS = ("forward", "pair")


def _counter(*lists):
    """A function adding ``n`` to entry ``i`` of each of ``lists`` (a
    site's and a function's statistics), holding nothing else: an entry
    counts its replays without a reference to its function."""
    def count(i, n=1):
        with _stats_lock:
            for st in lists:
                st[i] += n
    return count


def _weak(fn):
    """A callable returning ``fn``: through a ``weakref.WeakMethod`` for
    a bound method (the owner's jitted function must not keep its owner
    alive), else ``fn`` itself."""
    if fn is None:
        return None
    if hasattr(fn, "__self__") and hasattr(fn, "__func__"):
        return weakref.WeakMethod(fn)
    return lambda: fn


class ServiceFunction:
    """A callable owned by the service: one entry per call signature.

    A bound method given as ``fn`` or ``reads`` is held weakly: the
    owner (a trainer, a hybridized block's ``CachedOp``, an executor)
    holds this function, its entries hold their graphs and memory pools,
    and the owner's last reference dropping frees all of them at once,
    with no wait for Python's cyclic collector. A call after the owner
    is gone raises :class:`~mxnet_tpu_torch.base.MXNetError`."""

    def __init__(self, fn, site, token_key, reads, kind="forward"):
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        self._fn_ref = _weak(fn)
        self._site = site
        self._token_key = token_key
        self._reads_ref = _weak(reads)
        self._kind = kind
        self._st = _site_stats(site)
        # this function's own statistics (as its site's) and its
        # entries' build records
        self._own = _zeros()
        self._count = _counter(self._st, self._own)
        self._seen = {}  # argument signature -> entry
        self._miss_lock = threading.Lock()
        self.__name__ = getattr(fn, "__qualname__", None) or getattr(
            fn, "__name__", site)
        with _lock:
            _REGISTRY[token_key] = weakref.ref(self)

    def _target(self, ref, what):
        fn = ref()
        if fn is None:
            raise MXNetError(f"{self._what()}: the object that owns this "
                             f"compiled function ({what}) is gone")
        return fn

    def __call__(self, *args):
        fn = self._target(self._fn_ref, "its body")
        if not _ENABLED or inside():
            with nested():
                return fn(*args)
        reads, rkey = self._reads()
        sig = _sig_node(args)
        entry = self._fresh(sig, rkey)
        if entry is None:
            with self._miss_lock:
                entry = self._fresh(sig, rkey)
                if entry is None:
                    return self._miss(fn, sig, rkey, args, reads)
        self._count(0)
        return self._run(fn, entry, args, reads)

    def cached(self, *args):
        """Whether a call with ``args`` now would find its signature's
        entry built over the same reads and backend flags (a replay on a
        card) rather than make one."""
        return self._fresh(_sig_node(args), self._reads()[1]) is not None

    def _reads(self):
        """``(reads, key)``: the tensors read beside the arguments, and
        their pointers, shapes, dtypes and grad requirements with the
        backend flags and AMP's generation (``_amp_core.GEN``: an entry
        captured before ``amp.init`` or ``amp.turn_off`` holds the other
        precision's casts), which an entry must have been built over."""
        reads = [] if self._reads_ref is None else \
            list(self._target(self._reads_ref, "its reads")())
        return reads, (_flags(), _amp_core.GEN,
                       tuple((t.data_ptr(), t.shape, t.dtype,
                              t.requires_grad) for t in reads))

    def _fresh(self, sig, rkey):
        """The entry of ``sig`` if it was built over the same reads and
        backend flags."""
        entry = self._seen.get(sig)
        return entry if entry is not None and entry.reads == rkey else None

    def _what(self):
        return f"{self._site}[{self.__name__}]"

    def _count_uncaptured(self, reason):
        with _stats_lock:
            reasons = _UNCAPTURED.setdefault(self._site, {})
            reasons[reason] = reasons.get(reason, 0) + 1

    def _run(self, fn, entry, args, reads):
        if entry.kind == "host":
            self._count_uncaptured(entry.reason)
        elif entry.kind == "graph":
            self._count(6)
        elif entry.kind == "pair":
            if entry.busy():  # a backward is due: this call runs eagerly
                self._count(7)
                with nested():
                    return fn(*args)
            if not entry.captured:
                with self._miss_lock, _capture_lock:
                    if not entry.captured:
                        t0 = time.perf_counter()
                        entry.capture(fn, args, reads)
                        self._built(entry, t0, True)
                        entry.record["pool_bytes"] = entry.pool_bytes
                        self._cost(entry)
        return entry(fn, args, reads)

    def _built(self, entry, t0, captured):
        ms = (time.perf_counter() - t0) * 1e3
        self._count(2)
        self._count(3, ms)
        if captured:
            self._count(4)
            self._count(5, ms)
        entry.record["ms"] = ms
        if _profiler._RECORDING:   # the profiler's compile track
            _profiler.record_compile(self._site, ms,
                                     "capture" if captured else "compile",
                                     self._st[0], self._st[1])

    def _miss(self, fn, sig, rkey, args, reads):
        """Make the entry for ``sig`` over the reads ``rkey`` and return
        the function's first call (on the CPU a plain call; on a card run
        eagerly on the capture stream, a forward then captured). A stale
        entry of ``sig`` is dropped first, so that the capture (which
        empties the allocator's cache) frees its pool."""
        from .ops import registry

        self._count(1)
        self._seen.pop(sig, None)
        leaves = []
        _flatten(args, leaves)
        device = _device_of(leaves) or _device_of(reads)
        t0 = time.perf_counter()
        kind = "plain" if device is None else self._kind
        pool_bytes = 0
        if device is None:
            with registry.watching_host_ops() as seen, _counting() as cost:
                out = _Plain()(fn, args)
            entry = _Host(_host_reason(seen)) if seen else _Plain()
        elif kind == "pair":
            entry = _Pair(device, self._what(), self._count)
            with _capture_lock, registry.watching_host_ops() as seen, \
                    _counting() as cost:
                out = entry.eager(fn, args)
            if seen:
                entry = _Host(_host_reason(seen))
        else:
            with _capture_lock:
                entry = _Graph(fn, args, device, self._what())
            out, entry.first, cost = entry.first, None, entry.cost
            if entry.host is not None:
                entry = _Host(entry.host)
            else:
                pool_bytes = entry.pool_bytes
        entry.reads = rkey
        entry.cost = cost
        entry.record = {"kind": entry.kind if entry.kind == "host" else kind,
                        "ms": 0.0,
                        "shapes": [tuple(t.shape) for t in leaves],
                        "pool_bytes": pool_bytes}
        if cost is not None:
            entry.record["flops"] = cost.flops
            entry.record["int_ops"] = cost.int_ops
        if entry.kind == "host":
            entry.record["reason"] = entry.reason
            self._count_uncaptured(entry.reason)
        elif kind != "pair":
            self._built(entry, t0, device is not None)
        self._cost(entry)
        self._seen[sig] = entry
        return out

    def _cost(self, entry):
        """Record ``entry``'s counted flops and pool bytes under this
        function's token (``telemetry.costs``)."""
        if entry.cost is None:
            return
        from .telemetry import costs

        costs.record_executable(
            self._site, self._token_key, cost=entry.cost.cost(),
            mem={"temp_size_in_bytes": entry.record["pool_bytes"]},
            source="capture" if entry.record["pool_bytes"] else "first_call")

    def stats(self):
        """This function's statistics (as :func:`stats` per site) and
        each live entry's ``{kind, ms, shapes, pool_bytes}`` (its input
        shapes; ``ms`` the time its capture took; ``pool_bytes`` what its
        graphs' memory pool took, 0 on the CPU), with ``flops`` and
        ``int_ops`` where telemetry counted them."""
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


def jit(fn, *, site, token, reads=None, kind="forward"):
    """The port's counterpart of ``mxnet_tpu.compile.jit``.

    fn : a function of tensors (in tuples, lists and dicts; other
        arguments are static and part of the key) returning tensors in
        such a structure. A bound method is held weakly (so is
        ``reads``): the owner keeps the returned function, not the
        other way round.
    site : metric bucket: ``"cachedop"``, ``"serving"``, ``"trainer"``
        or ``"executor"``.
    token : the function's identity (hashable); one registry entry per
        token.
    reads : None, or a callable returning the tensors ``fn`` reads
        beside its arguments; an entry holds their data pointers, shapes,
        dtypes and grad requirements, and is built anew when they
        change. For a ``"pair"``, the reads that require grad are
        differentiated (a block's parameter leaves).
    kind : ``"forward"`` (one graph: an inference forward, or a step
        that writes its state in place) or ``"pair"`` (forward and
        backward under ``autograd.record()``); see the module's
        docstring.
    """
    return ServiceFunction(fn, site, _token_key(site, token), reads, kind)
