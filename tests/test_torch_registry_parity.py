"""The port's op registry against the JAX package's, name for name: both
``list_ops()`` hold the same 630 names, each alias of the JAX registry
resolves in the port to an op of the same outputs and gradient flag,
and the JAX package's eager (data-shaped) ops are host ops in the port.
This replaces the gap table that ROADMAP.md A kept until the NumPy
frontend was ported."""
import mxnet_tpu  # noqa: F401  (registers the JAX ops)
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry


def test_list_ops_equal_both_ways():
    ours, theirs = set(registry.list_ops()), set(jreg.list_ops())
    assert sorted(theirs - ours) == []
    assert sorted(ours - theirs) == []
    assert len(ours) == 630


def _numpy_frontend(name):
    return name.startswith(("_np_", "_npi_", "_npx_"))


def test_every_jax_name_and_alias_resolves_alike():
    """Every JAX name resolves in the port; the NumPy frontend's ops have
    the JAX ops' output counts and gradient flags."""
    for name, op in jreg._REGISTRY.items():
        registry.get(name)
        if not _numpy_frontend(name):
            continue
        if callable(op.num_outputs):
            assert callable(registry._NUM_OUTPUTS[registry.canonical(name)])
        elif op.num_outputs not in (None, 1):
            assert registry.num_outputs(name) == op.num_outputs, name
        assert registry.differentiable(name) == op.differentiable, name


def test_the_jax_eager_ops_are_host_ops():
    eager = sorted(n for n in jreg.list_ops()
                   if jreg.get(n).eager and _numpy_frontend(n))
    assert eager == sorted([
        "_npi_bincount", "_npi_delete", "_npi_insert_scalar",
        "_npi_insert_slice", "_npi_insert_tensor", "_npi_nonzero",
        "_npi_share_memory", "_npi_unique", "_npx_nonzero"])
    assert all(registry.is_host(n) for n in eager)
    # eigh reads cuSOLVER's status, as linalg_syevd: host ops in the port
    assert {n for n in registry.list_ops() if registry.is_host(n)
            and _numpy_frontend(n)} - set(eager) == {"_npi_eigh",
                                                     "_npi_eigvalsh"}


def test_chip_smoke_defines_each_top_level_name_once():
    """A second definition of a helper in chip_smoke.py silently replaces
    the first for every phase that calls it."""
    import ast
    import collections
    import pathlib

    src = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    names = collections.Counter()
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] += 1
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    assert [n for n, c in names.items() if c > 1] == []
