"""``mx.random``: the process-wide seeded random generators.

Counterpart of ``mxnet_tpu/random.py`` (MXNet's ``RandGenerator``: one
stateful generator per device, seeded by ``mx.random.seed``). The JAX
package keeps one threefry key and splits it for every draw; the port
keeps one ``torch.Generator`` per device (Philox on the card, mt19937 on
the CPU), made on first use from the current seed and reseeded by
``seed``. The two never agree by value: under one seed the port repeats
its own draws, not the JAX package's bits.

Ported: ``seed``, ``current_seed`` and ``generator``, which imperative
random ops draw from (``nd.Dropout``, ``nd.random.uniform`` and
``nd.random.normal``); ``get_state`` and ``set_state``, which
``ShardedTrainer`` checkpoints write and read under ``__rng_seed__`` and
``__rng_key__``. The port writes its generator's own state there (uint8:
Philox's seed and offset on the card, mt19937's state on the CPU). A
checkpoint of the JAX package holds a threefry key instead, which no
torch generator can continue: reading one restores the seed alone, so the
sample stream does not cross between the packages (weights do, by name).

A forward that is recomputed in its backward (``ShardedTrainer``'s
``remat``) must draw the same Dropout masks twice: :func:`snapshot`
marks where such a forward starts, and its ``again()`` scope makes the
recomputation draw what the forward drew, leaving the generator where
it was. Outside a capture that is the generator's saved state, set and
restored around the recomputation. Inside a capture the generator's
state cannot be read or set, so the recomputation draws, through
``graphsafe_set_state``, from a second generator state of the card
(:func:`recompute_generator`), which every graph captured after it
exists registers too; before each replay of a graph whose capture drew
from it, that state is set to the card generator's seed and offset
(``kernels.before_replay``), so its draws repeat the forward's. That
holds when the recomputed forwards are the graph's first draws and each
is recomputed before the next begins, as in a trainer's step: a
forward, its backward, then the next microbatch.

Every CUDA graph the compile service captures registers the card's
generator (``CUDAGraph.register_generator_state``): a replay reads the
generator's seed and offset at launch and advances the offset by what
the capture drew, so each replayed Dropout draws a new mask, ``seed``
restarts the stream for replays and eager calls alike, and
``get_state`` / ``set_state`` keep working between replays (not inside
a capture).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .context import Context

__all__ = ["seed", "current_seed", "generator", "get_state", "set_state",
           "snapshot", "recompute_generator"]

_lock = threading.Lock()
_seed = 0
_generators: dict = {}
_recompute: dict = {}   # card -> the generator state recomputations draw


def seed(seed_state, ctx=None) -> None:
    """Seed the generators of every device with ``seed_state`` (parity:
    ``mx.random.seed``). ``ctx`` is accepted and, as in the JAX package,
    does not narrow which generators are reseeded."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        for gen in _generators.values():
            gen.manual_seed(_seed)


def current_seed() -> int:
    return _seed


def generator(device) -> torch.Generator:
    """The process-wide ``torch.Generator`` of ``device`` (a
    ``torch.device``, a device string or a Context), made on first use
    from the current seed."""
    if isinstance(device, Context):
        device = device.torch_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _generators.get(device)
        if gen is None:
            gen = _generators[device] = torch.Generator(device=device)
            gen.manual_seed(_seed)
        return gen


def get_state(device) -> torch.Tensor:
    """The state of ``device``'s generator, a uint8 CPU tensor."""
    return generator(device).get_state()


def set_state(seed_state, key, device) -> None:
    """Restore what :func:`current_seed` and :func:`get_state` returned.
    ``key`` (a tensor or numpy array) of another dtype than uint8 is a
    JAX package's threefry key: then only the seed is restored, as by
    :func:`seed`, and the sample stream restarts from it."""
    global _seed
    key = torch.as_tensor(key)
    if key.dtype != torch.uint8:
        seed(seed_state)
        return
    gen = generator(device)
    with _lock:
        _seed = int(seed_state)
        gen.set_state(key.to("cpu").contiguous())


def _card(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def recompute_generator(device, create=False):
    """The generator state a recomputation inside a CUDA graph draws from
    on the card ``device`` (None until a :func:`snapshot` made one, unless
    ``create``)."""
    device = _card(device)
    with _lock:
        gen = _recompute.get(device)
    if gen is None and create:
        gen = generator(device).clone_state()
        with _lock:
            gen = _recompute.setdefault(device, gen)
    return gen


def _sync_recompute(device):
    """Before a replay: the recomputation state at the card generator's
    seed and offset, where the replayed forward starts drawing."""
    recompute_generator(device).set_state(generator(device).get_state())


class _Snapshot:
    """Where a forward that will be recomputed starts drawing."""

    def __init__(self, device):
        self._device = _card(device)
        self._gen = generator(self._device)
        self._capturing = self._device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing()
        self._state = None if self._capturing else self._gen.get_state()
        if self._device.type == "cuda":
            recompute_generator(self._device, create=True)

    @contextlib.contextmanager
    def again(self):
        """Within the scope the generator draws what it drew after the
        snapshot; afterwards it is where it was before the scope."""
        gen = self._gen
        if not self._capturing:
            now = gen.get_state()
            gen.set_state(self._state)
            try:
                yield
            finally:
                gen.set_state(now)
            return
        from . import kernels

        device = self._device
        if not kernels.before_replay(("recompute", device),
                                     lambda: _sync_recompute(device)):
            raise RuntimeError("a recomputation inside a CUDA graph "
                               "capture needs the capture's record "
                               "(kernels.recording)")
        outer = gen.graphsafe_get_state()
        gen.graphsafe_set_state(recompute_generator(device))
        try:
            yield
        finally:
            gen.graphsafe_set_state(outer)


def snapshot(device) -> _Snapshot:
    """Mark the generator of ``device`` where a forward that will be
    recomputed starts drawing; ``snapshot(...).again()`` is the scope of
    the recomputation."""
    return _Snapshot(device)
