"""The port's fused optimizer steps (mxnet_tpu_torch/kernels/opt_step.py,
ops/optimizer_op.py) against the JAX package's: the plain PyTorch
versions against the JAX ops and against the Pallas kernels K1/K2 run in
interpret mode, the multi-tensor in-place wrappers and the dispatch rule.
The CUDA kernels are held against the plain versions on a card in
tests/test_torch_card.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.kernels import opt_step as jopt
from mxnet_tpu.ops import optimizer_op as jop
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.kernels import opt_step
from mxnet_tpu_torch.ops import optimizer_op as op

SHAPES = [(1,), (127,), (129,), (40, 33), (16385,)]
# (rescale_grad, clip_gradient, wd)
HYPERS = [(1.0, -1.0, 0.0), (0.5, -1.0, 1e-4), (1.0, 0.004, 1e-2),
          (0.5, 0.004, 1e-4)]


def _inputs(shape, seed, n=4):
    rs = np.random.RandomState(seed)
    out = [(rs.randn(*shape) * s).astype(np.float32)
           for s in (0.05, 0.01, 1e-3, 1e-3)][:n]
    if n == 4:
        out[3] = np.square(out[3])
    return out


def _t(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("rescale,clip,wd", HYPERS)
@pytest.mark.parametrize("shape", SHAPES)
def test_sgd_mom_plain_is_bitwise_the_jax_op(shape, rescale, clip, wd):
    """Plain PyTorch and the JAX op run eagerly (op by op, no FMA
    contraction on either side): bitwise equal on the CPU."""
    w, g, m = _inputs(shape, seed=1, n=3)
    kw = dict(lr=0.05, momentum=0.9, wd=wd, rescale_grad=rescale,
              clip_gradient=clip)
    got = op.sgd_mom_update(*_t([w, g, m]), **kw)
    want = jop.sgd_mom_update.fn(*(jnp.asarray(a) for a in (w, g, m)), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = op.sgd_update(*_t([w, g]), lr=0.05, wd=wd, rescale_grad=rescale,
                        clip_gradient=clip)
    want = jop.sgd_update.fn(jnp.asarray(w), jnp.asarray(g), lr=0.05, wd=wd,
                             rescale_grad=rescale, clip_gradient=clip)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rescale,clip,wd", HYPERS)
@pytest.mark.parametrize("shape", SHAPES)
def test_adam_plain_matches_the_jax_op(shape, rescale, clip, wd):
    """Moments bitwise; the weight to one unit in the last place (rtol
    2e-7 of the step): PyTorch's vectorised CPU sqrt is not correctly
    rounded (it differs from numpy's in the last place for about 0.6% of
    inputs), XLA's is. On the card torch.sqrt is, which is what the CUDA
    kernel is held to bit for bit."""
    w, g, m, v = _inputs(shape, seed=2)
    kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=wd,
              rescale_grad=rescale, clip_gradient=clip)
    got = op.adam_update(*_t([w, g, m, v]), **kw)
    want = jop.adam_update.fn(*(jnp.asarray(a) for a in (w, g, m, v)), **kw)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    step = np.abs(w - np.asarray(want[0])).max()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=2e-7 * step + np.spacing(np.abs(w)).max())


@pytest.mark.parametrize("rescale,clip,wd", HYPERS)
def test_plain_matches_pallas_kernels_in_interpret_mode(rescale, clip, wd):
    """Against the TPU kernels K1/K2 (interpret mode, which XLA compiles
    and may contract into FMAs): rtol 1e-6, atol 1e-7, the bound the JAX
    package's own tests hold the kernel to against its eager op."""
    shape = (5000,)
    w, g, m, v = _inputs(shape, seed=3)
    kw = dict(wd=wd, rescale_grad=rescale, clip_gradient=clip)
    lr = 0.05
    got = op.sgd_mom_update(*_t([w, g, m]), lr=lr, momentum=0.9, **kw)
    want = jopt._kernel_sgd(*(jnp.asarray(a) for a in (w, g, m)), lr,
                            momentum=0.9, interpret=True, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    got = op.adam_update(*_t([w, g, m, v]), lr=1e-3, **kw)
    want = jopt._kernel_adam(*(jnp.asarray(a) for a in (w, g, m, v)), 1e-3,
                             interpret=True, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_clip_propagates_nan_as_the_jax_op():
    g = np.array([np.nan, 1.0, -1.0, 1e-4], np.float32)
    w = np.ones(4, np.float32)
    m = np.zeros(4, np.float32)
    got = op.sgd_mom_update(*_t([w, g, m]), lr=0.1, momentum=0.9,
                            clip_gradient=0.5)
    want = jop.sgd_mom_update.fn(*(jnp.asarray(a) for a in (w, g, m)),
                                 lr=0.1, momentum=0.9, clip_gradient=0.5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.isnan(got[0][0].item()) and got[1][1].item() == \
        np.float32(-0.1) * np.float32(0.5)


@pytest.mark.parametrize("family", ["opt_sgd", "opt_adam"])
def test_multi_tensor_plain_updates_in_place_and_skips(family):
    shapes = [(3,), (17, 5), (1,), (0,), (300,)]
    state = [_inputs(s, seed=i + 5) for i, s in enumerate(shapes)]
    wds = [1e-4, 0.0, 1e-2, 0.0, 1e-4]
    lr = torch.tensor(1e-3)
    hyper = {"momentum": 0.9} if family == "opt_sgd" else {
        "beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    hyper.update(rescale_grad=0.5, clip_gradient=0.01)
    cols = [_t([st[j] for st in state]) for j in range(4)]
    lists = cols[:3] if family == "opt_sgd" else cols
    before = [[t.clone() for t in col] for col in lists]
    counts = kernels.launch_counts()
    kernels.dispatch(family, *lists, lr, wds, skip=torch.ones(1), **hyper)
    for col, old in zip(lists, before):
        assert all(torch.equal(a, b) for a, b in zip(col, old))
    kernels.dispatch(family, *lists, lr, wds, skip=torch.zeros(1), **hyper)
    assert kernels.launch_counts() == counts  # CPU: the plain version
    for i, wd in enumerate(wds):
        args = [before[j][i] for j in range(len(before))]
        if family == "opt_sgd":
            want = op.sgd_mom_update(*args, lr=lr, wd=wd, **hyper)
        else:
            want = op.adam_update(*args, lr=lr, wd=wd, **hyper)
        updated = [0, 2] if family == "opt_sgd" else [0, 2, 3]
        for j, t in zip(updated, want):
            assert torch.equal(lists[j][i], t)
    assert all(torch.equal(a, b) for a, b in zip(lists[1], before[1]))


def test_adam_rule_folds_bias_correction_into_lr_like_jax():
    """``opt_rules._adam_update`` computes lr * sqrt(1 - b2^t) / (1 - b1^t)
    in float32 on the device; the JAX rule computes the same expression
    under jit (pow may differ in the last place)."""
    for t in (1.0, 2.0, 3.0, 20.0):
        lr = torch.tensor(1e-4)
        tt = torch.tensor(t)
        got = (lr * torch.sqrt(1.0 - 0.999 ** tt) / (1.0 - 0.9 ** tt)).item()
        jt = jnp.asarray(t, jnp.float32)
        want = float(jnp.asarray(1e-4, jnp.float32) *
                     jnp.sqrt(1.0 - 0.999 ** jt) / (1.0 - 0.9 ** jt))
        np.testing.assert_allclose(got, want, rtol=2e-7)


def test_cuda_wrappers_refuse_cpu_tensors():
    w = [torch.zeros(4)]
    lr = torch.tensor(0.1)
    with pytest.raises(ValueError, match="CUDA"):
        opt_step.opt_sgd(w, w, w, lr, [0.0], momentum=0.9)
    with pytest.raises(ValueError, match="CUDA"):
        opt_step.opt_adam(w, w, w, w, lr, [0.0])
    with pytest.raises(ValueError, match="unequal"):
        opt_step.opt_adam(w, w, w, [], lr, [0.0])
    assert kernels.entry("opt_sgd").replaces == \
        "mxnet_tpu/kernels/opt_step.py:_kernel_sgd"
    assert kernels.entry("opt_adam").replaces == \
        "mxnet_tpu/kernels/opt_step.py:_kernel_adam"
    assert opt_step._TABLE_DTYPE.itemsize == 56
