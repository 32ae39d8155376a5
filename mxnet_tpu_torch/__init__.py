"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu, for NVIDIA Hopper.

Usage mirrors the JAX package (``import mxnet_tpu_torch as mx``), with
one difference: the default context is the card, ``gpu(0)``. Pass
``ctx=mx.cpu()`` to run on the CPU; without a card and without that,
array creation, ``Block.initialize`` and serving raise.

Plain tensor code is PyTorch; the JAX package's Pallas kernels become
kernels written by hand for Hopper (``kernels/``, sources in ``csrc/``),
built with ``nvcc`` at first use. This package imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .base import MXNetError
from .context import Context, cpu, current_context, gpu, num_gpus
from . import autograd
from . import random
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import initializer
from . import initializer as init
from . import kernels
from . import name
from . import symbol
from . import symbol as sym
from . import executor
from . import gluon
from . import native
from . import recordio
from . import io
from . import image
from . import image as img
from . import model
from . import contrib
from . import lr_scheduler
from . import optimizer
from . import kvstore
from . import kvstore as kv
from . import parallel
from . import serving
from . import convert
from . import checkpoint
from . import compile
from . import cached_op
from . import metric
from . import callback
from . import monitor
from . import module
from . import module as mod
from . import operator
from . import library
from . import attribute
from .attribute import AttrScope
from . import amp
from . import visualization
from . import visualization as viz

__all__ = ["MXNetError", "Context", "cpu", "gpu", "num_gpus",
           "current_context", "autograd", "random", "nd", "ndarray",
           "NDArray", "initializer", "init", "kernels", "name", "symbol",
           "sym", "gluon", "io", "native", "recordio", "image", "img",
           "model", "contrib", "lr_scheduler", "optimizer", "kvstore", "kv",
           "parallel", "serving", "convert", "checkpoint", "compile",
           "cached_op", "executor", "metric", "callback", "monitor",
           "module", "mod", "operator", "library", "attribute",
           "AttrScope", "amp", "visualization", "viz", "np", "npx",
           "util", "test_utils", "__version__"]

# loaded at first use, as the JAX package's __init__ :83-93 maps them
_LAZY = {"np": "numpy", "npx": "numpy_extension", "util": "util",
         "test_utils": "test_utils", "numpy": "numpy",
         "numpy_extension": "numpy_extension"}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib

    mod = importlib.import_module("." + target, __name__)
    globals()[name] = mod
    return mod
