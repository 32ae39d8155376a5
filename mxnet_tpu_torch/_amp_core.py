"""AMP's cast hook, the part of ``amp`` that every op call reads.

Counterpart of ``mxnet_tpu/_amp_core.py`` (:28-75; MXNet 1.x's
``src/nnvm/low_precision_pass.cc``). MXNet rewrites a graph with
``amp_cast`` nodes; here both dispatch paths, the imperative
``ndarray._invoke`` and the symbol evaluator ``Symbol._build_eval``,
call :func:`cast_inputs` on an op's tensors before the op runs, while
AMP is on. A captured graph (``compile.py``) therefore holds the casts
of the state it was captured under: ``GEN`` moves at every
:func:`configure` and :func:`deactivate`, and is part of every compiled
entry's key, so ``amp.init()`` and ``amp.turn_off()`` make the next call
capture anew rather than replay a graph of the other precision.

* ``TARGET_OPS`` cast their float32 and float64 inputs to the target
  dtype (bfloat16 or float16);
* ``FP32_OPS`` cast their half inputs to float32;
* ``WIDEST_OPS`` cast their floating inputs to the widest among them.
"""
from __future__ import annotations

import torch

ACTIVE = False
GEN = 0                 # moves at every change; part of the compile keys
TARGET_DTYPE = torch.bfloat16
TARGET_OPS = frozenset()
FP32_OPS = frozenset()
WIDEST_OPS = frozenset()

_LOW = (torch.float16, torch.bfloat16)
_HIGH = (torch.float32, torch.float64)


def configure(target_dtype, target_ops, fp32_ops, widest_ops):
    """Turn the hook on with these op lists (``target_dtype`` a name or a
    ``torch.dtype``)."""
    global ACTIVE, GEN, TARGET_DTYPE, TARGET_OPS, FP32_OPS, WIDEST_OPS
    TARGET_DTYPE = getattr(torch, target_dtype) \
        if isinstance(target_dtype, str) else target_dtype
    TARGET_OPS = frozenset(target_ops)
    FP32_OPS = frozenset(fp32_ops)
    WIDEST_OPS = frozenset(widest_ops)
    ACTIVE = True
    GEN += 1


def deactivate():
    global ACTIVE, GEN
    ACTIVE = False
    GEN += 1


def cache_stale(obj):
    """Whether ``obj``'s cache of compiled entries predates the current
    generation; stamps ``obj`` with it either way. The compile service
    keys its entries on ``GEN`` itself; this is for a holder of another
    cache."""
    stale = getattr(obj, "_amp_gen", GEN) != GEN
    obj._amp_gen = GEN
    return stale


def cast_inputs(op_name, tensors):
    """The AMP cast of one op's input tensors (a new list). Called only
    while ``ACTIVE``."""
    if op_name in TARGET_OPS:
        return [t.to(TARGET_DTYPE) if t.dtype in _HIGH else t
                for t in tensors]
    if op_name in FP32_OPS:
        return [t.to(torch.float32) if t.dtype in _LOW else t
                for t in tensors]
    if op_name in WIDEST_OPS:
        dts = {t.dtype for t in tensors if t.is_floating_point()}
        if len(dts) > 1:
            widest = dts.pop()
            for dt in dts:
                widest = torch.promote_types(widest, dt)
            return [t.to(widest) if t.is_floating_point() else t
                    for t in tensors]
    return tensors
