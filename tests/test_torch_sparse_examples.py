"""The three ``examples/sparse/`` flows at their defaults for 2 epochs:
the port's copies (``chip_smoke.sparse_fm_example``,
``sparse_linear_example``, ``sparse_mf_example``, which the card phases
run) on the CPU against the JAX example's own ``main`` (its printed
per-epoch numbers), each within 1e-4."""
import importlib.util
import re
from pathlib import Path

import pytest

import mxnet_tpu_torch as mx
from chip_smoke import (sparse_fm_example, sparse_linear_example,
                        sparse_mf_example)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
EPOCHS = 2


def _jax_main(name, capsys, monkeypatch):
    monkeypatch.setenv("MXTPU_SKIP_PROBE", "1")
    spec = importlib.util.spec_from_file_location(
        f"sparse_example_{name}", ROOT / "examples" / "sparse" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main(["--num-epoch", str(EPOCHS)])
    epochs = {}
    for line in capsys.readouterr().out.splitlines():
        ep = re.match(r"Epoch\[(\d+)\]", line)
        if ep:
            for key, val in re.findall(r"Train-(\w+)=([0-9.eE+-]+)", line):
                epochs.setdefault(int(ep.group(1)), {})[key.lower()] = \
                    float(val)
    return [epochs[e] for e in sorted(epochs)]


@pytest.mark.parametrize("name,fn", [
    ("factorization_machine", sparse_fm_example),
    ("linear_classification", sparse_linear_example),
    ("matrix_factorization", sparse_mf_example)])
def test_sparse_example_epochs_match_the_jax_example(name, fn, capsys,
                                                     monkeypatch):
    want = _jax_main(name, capsys, monkeypatch)
    got = fn(mx.cpu(), num_epoch=EPOCHS)
    assert len(want) == len(got) == EPOCHS
    for e, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (g, w)
        for k in g:
            assert abs(g[k] - w[k]) <= TOL, (name, e, k, g[k], w[k])
