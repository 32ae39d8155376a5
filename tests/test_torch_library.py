"""``mx.library.load`` in the port against the JAX package, on the CPU.

``examples/extensions/lib_custom_op/relu_lib.cc`` (the JAX package's
sample of its extension C ABI, ``mxnet_tpu/library.py:18-40``) is built
with the system ``g++`` in a fixture, which skips when there is no
``g++``, as ``tests/test_extension.py`` does. Both packages load the same
library: ``my_relu`` and ``my_gemm`` give the same values (bit for bit:
one host loop computes both), run on host memory (the port copies the
inputs to the host and the result back), take no gradient, and appear
as ``mx.nd.<name>`` and ``mx.sym.<name>``. A ``.py`` extension is run and
its ops exposed. In the port, a hybridized block or an executor calling
a loaded op runs uncaptured, each call counted under its reason.
"""
import os
import shutil
import subprocess

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import compile as mxc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ext_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ available")
    src = os.path.join(REPO, "examples", "extensions", "lib_custom_op",
                       "relu_lib.cc")
    out = str(tmp_path_factory.mktemp("ext") / "librelu_lib.so")
    subprocess.run([gxx, "-shared", "-fPIC", "-O2", "-o", out, src],
                   check=True)
    mx.library.load(out, verbose=False)
    jmx.library.load(out, verbose=False)
    return out


def _x(seed, *shape, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


# the JAX package runs with x64 off, so its float64 and int64 arrays are
# float32 and int32: those dtypes are held against numpy alone
WIDE = (np.float64, np.int64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64])
def test_my_relu_matches_jax_bit_for_bit(ext_lib, dtype):
    x = (_x(1, 4, 6) * 10).astype(dtype)
    with mx.cpu():
        got = mx.nd.my_relu(mx.nd.array(x)).asnumpy()
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, np.maximum(x, 0))
    if dtype not in WIDE:
        np.testing.assert_array_equal(
            got, jmx.nd.my_relu(jmx.nd.array(x)).asnumpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_my_gemm_matches_jax_bit_for_bit(ext_lib, dtype):
    a, b = _x(2, 5, 3, dtype=dtype), _x(3, 3, 7, dtype=dtype)
    with mx.cpu():
        got = mx.nd.my_gemm(mx.nd.array(a), mx.nd.array(b)).asnumpy()
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got, a @ b, rtol=1e-5, atol=1e-6)
    if dtype not in WIDE:
        np.testing.assert_array_equal(
            got, jmx.nd.my_gemm(jmx.nd.array(a), jmx.nd.array(b)).asnumpy())


def test_loaded_ops_take_no_gradient_and_refuse_bad_inputs(ext_lib):
    from mxnet_tpu_torch.ops import registry as reg

    assert not reg.differentiable("my_relu")
    with mx.cpu(), reg.watching_host_ops() as seen:
        mx.nd.my_relu(mx.nd.ones((2,)))
    assert seen == ["my_relu"]
    with mx.cpu():
        x = mx.nd.array(_x(4, 3, 3))
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.my_relu(x) + x
        y.backward()
        np.testing.assert_array_equal(x.grad.asnumpy(), np.ones((3, 3)))
        with pytest.raises(RuntimeError, match="infer_shape"):
            mx.nd.my_gemm(mx.nd.ones((2, 3)), mx.nd.ones((2, 3)))
        with pytest.raises(TypeError):
            mx.nd.my_relu(mx.nd.ones((2,), dtype="float16"))


def test_loaded_op_in_a_symbol_and_an_executor_runs_uncaptured(ext_lib):
    x = _x(5, 2, 4)
    s = mx.sym.my_relu(mx.sym.var("x")) * 2
    js = jmx.sym.my_relu(jmx.sym.var("x")) * 2
    assert s.infer_shape(x=(2, 4))[1] == [(2, 4)]
    mxc.reset_stats()
    with mx.cpu():
        ex = s.simple_bind(x=(2, 4), grad_req="null")
        ex.arg_dict["x"][:] = mx.nd.array(x)
        got = ex.forward()[0].asnumpy()
        ex.forward()
    want = js.eval(x=jmx.nd.array(x))[0].asnumpy()
    np.testing.assert_array_equal(got, want)
    assert mxc.stats()["executor"]["uncaptured"] == {"host op my_relu": 2}


def test_loaded_op_in_a_hybridized_block_runs_uncaptured(ext_lib):
    class Net(mx.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return F.my_relu(x) - 1

    net = Net()
    net.hybridize()
    mxc.reset_stats()
    x = np.array([[-1.0, 2.0]], np.float32)
    with mx.cpu():
        for _ in range(3):
            out = net(mx.nd.array(x)).asnumpy()
    np.testing.assert_array_equal(out, [[-1.0, 1.0]])
    st = mxc.stats()["cachedop"]
    assert st["uncaptured"] == {"host op my_relu": 3}
    assert st["captures"] == st["compiles"] == 0


def test_a_python_extension_registers_its_ops(tmp_path):
    ext = tmp_path / "port_ext.py"
    ext.write_text(
        "from mxnet_tpu_torch.ops import registry\n"
        "registry.register('py_triple')(lambda x: x * 3)\n")
    ns = mx.library.load(str(ext))
    assert mx.library.load(str(ext)) is ns
    with mx.cpu():
        out = mx.nd.py_triple(mx.nd.ones((2, 2)))
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 2), 3.0))
    assert hasattr(mx.sym, "py_triple")
    assert str(ext) in mx.library.loaded_libraries()


def test_load_refuses_what_is_not_an_extension(tmp_path):
    for m in (mx, jmx):
        with pytest.raises(ValueError, match="does not exist"):
            m.library.load(str(tmp_path / "missing.so"))
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ available")
    src = tmp_path / "other.cc"
    src.write_text('extern "C" int other(void) { return 0; }\n')
    lib = str(tmp_path / "libother.so")
    subprocess.run([gxx, "-shared", "-fPIC", "-o", lib, str(src)],
                   check=True)
    for m in (mx, jmx):
        with pytest.raises(ValueError, match="not an mxtpu extension"):
            m.library.load(lib)
