"""``mx.sym.contrib``: the contrib ops without their prefix, for building
graphs.

Counterpart of ``mxnet_tpu/symbol/contrib.py``: every op whose name or
an alias starts with ``_contrib_`` (``MultiBoxPrior``, ``box_nms``,
``ROIAlign``, ...). The control flow of ``mx.nd.contrib`` runs inside a
hybridized block's captured body instead of as graph nodes, as in the
JAX package. ``getnnz`` counts the non-zero entries of its input (the
op ``_contrib_getnnz``).
"""
from __future__ import annotations

import sys as _sys


def _expose_ops():
    from ..ndarray.contrib import _expose
    from . import _make_wrapper

    _expose(_sys.modules[__name__], _make_wrapper)


_expose_ops()
