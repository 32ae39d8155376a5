"""Runtime feature detection (counterpart of ``mxnet_tpu/runtime.py``,
MXNet 1.x ``python/mxnet/runtime.py``).

The same feature names as the JAX package, each probed from torch:
``CUDA`` from ``torch.cuda.is_available()``; ``CUDNN``, ``NCCL`` and
``BF16`` from torch's backends; ``TPU``, ``XLA``, ``PALLAS`` and ``SPMD``
are False (the port has none of them); ``PROFILER`` is True.

    features = mx.runtime.Features()
    features.is_enabled("CUDA")
"""
from __future__ import annotations

import collections

__all__ = ["Feature", "feature_list", "Features"]


class Feature:
    """One named capability flag."""

    def __init__(self, name, enabled):
        self.name = name
        self.enabled = bool(enabled)

    def __repr__(self):
        if self.enabled:
            return f"✔ {self.name}"
        return f"✖ {self.name}"


def _probe():
    import torch

    cuda = torch.cuda.is_available()
    feats = {}
    feats["TPU"] = False
    feats["CPU"] = True
    feats["CUDA"] = cuda
    feats["XLA"] = False
    feats["BF16"] = (torch.cuda.is_bf16_supported() if cuda
                     else torch.backends.mkldnn.is_available())
    feats["F16C"] = True          # float16 storage
    feats["INT64_TENSOR_SIZE"] = True
    feats["SPMD"] = False
    feats["PALLAS"] = False
    feats["DIST_KVSTORE"] = torch.distributed.is_available()
    feats["OPENMP"] = torch.backends.openmp.is_available()
    feats["SIGNAL_HANDLER"] = False
    feats["DEBUG"] = False
    feats["PROFILER"] = True
    feats["CUDNN"] = cuda and torch.backends.cudnn.is_available()
    feats["NCCL"] = cuda and torch.distributed.is_available() and \
        torch.distributed.is_nccl_available()
    feats["TENSORRT"] = False
    feats["MKLDNN"] = torch.backends.mkldnn.is_available()
    for off in ("OPENCV", "LAPACK"):
        feats[off] = False
    feats["BLAS_MKL"] = torch.backends.mkl.is_available()
    for off in ("BLAS_OPEN", "SSE", "CAFFE", "TVM_OP"):
        feats[off] = False
    return feats


def feature_list():
    """Every feature as a :class:`Feature`."""
    return [Feature(k, v) for k, v in _probe().items()]


class Features(collections.OrderedDict):
    """Feature name -> :class:`Feature` (probed once)."""

    instance = None

    def __new__(cls):
        if cls.instance is None:
            cls.instance = super().__new__(cls)
            cls.instance.update([(f.name, f) for f in feature_list()])
        return cls.instance

    def __repr__(self):
        return str(list(self.values()))

    def is_enabled(self, feature_name):
        feature_name = feature_name.upper()
        if feature_name not in self:
            raise RuntimeError(f"Feature '{feature_name}' is unknown, "
                               "known features are: "
                               f"{list(self.keys())}")
        return self[feature_name].enabled
