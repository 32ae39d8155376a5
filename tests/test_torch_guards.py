"""Guards of the PyTorch/CUDA port: it imports neither JAX nor the JAX
package, and it runs on the card unless told otherwise."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serving

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _forbidden(module):
    return module is not None and module.split(".")[0] in FORBIDDEN


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_and_no_jax_package():
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): m for f in files for m in _imports(f)
           if _forbidden(m)}
    assert not bad, f"port modules import JAX or the JAX package: {bad}"
    # the match is on the whole top-level name
    assert not _forbidden("mxnet_tpu_torch.kernels")
    assert _forbidden("mxnet_tpu.gluon") and _forbidden("jax.numpy")


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, mxnet_tpu_torch\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'mxnet_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_default_context_is_the_card_and_raises_without_one(monkeypatch):
    assert mx.current_context() == mx.gpu(0)
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
        assert mx.nd.zeros((2,)).context == mx.cpu()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mx.num_gpus() == 0
    with pytest.raises(mx.MXNetError, match="ctx=mx.cpu"):
        mx.nd.array(np.zeros(3, np.float32))
    with pytest.raises(mx.MXNetError, match="ctx=mx.cpu"):
        mx.gluon.nn.Dense(3, in_units=2).initialize()
    blk = mx.gluon.nn.Dense(3, in_units=2)
    blk.initialize(ctx=mx.cpu())
    with pytest.raises(mx.MXNetError, match="ctx=mx.cpu"):
        serving.ServedModel.from_block("m", blk, example_shape=(2,))
