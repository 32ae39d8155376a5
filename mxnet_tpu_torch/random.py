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
``nd.random.normal``).
"""
from __future__ import annotations

import threading

import torch

from .context import Context

__all__ = ["seed", "current_seed", "generator"]

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
