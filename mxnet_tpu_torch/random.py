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
"""
from __future__ import annotations

import threading

import torch

from .context import Context

__all__ = ["seed", "current_seed", "generator", "get_state", "set_state"]

_lock = threading.Lock()
_seed = 0
_generators: dict = {}


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
