"""The samplers of ``nd.random`` (``gamma``, ``exponential``,
``poisson``, ``negative_binomial``, ``randint``, ``multinomial``,
``shuffle``, ``bernoulli``) in the port against the JAX package's, on the
CPU.

Threefry and Philox never give the same bits, so both packages are held
to what they must share: each draw's support, dtype and shape, and the
sample mean and variance of 65,536 draws within 6 standard errors of the
distribution's closed form (MXNet's parameterisations: gamma by shape
and scale, exponential by rate, the negative binomial by ``k`` and
``p``). Both packages are seeded (``mx.random.seed``), so every run draws
the same numbers and no check can flake; a false alarm at 6 standard
errors has odds of about 1e-9. In the port alone: one seed repeats its
draws and another does not, ``multinomial``'s ``get_prob`` returns the
log-probability of each draw (MXNet 1.x's second output, which the JAX
op does not return), and ``shuffle`` permutes rows whole.
"""
import math

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx

N = 1 << 16
SIGMAS = 6.0


def _moments(mean, var, kurt_excess):
    """Mean, variance and the variance of one draw's squared deviation
    (``kappa4 + 2 var**2``)."""
    return mean, var, kurt_excess * var * var + 2 * var * var


A, B, LAM, K, P, LO, HI, PB = 2.5, 1.5, 3.0, 4, 0.3, -3, 7, 0.2
CASES = {
    "gamma": (dict(alpha=A, beta=B), _moments(A * B, A * B * B, 6 / A),
              "float32"),
    "exponential": (dict(lam=LAM), _moments(1 / LAM, 1 / LAM ** 2, 6.0),
                    "float32"),
    "poisson": (dict(lam=LAM), _moments(LAM, LAM, 1 / LAM), "float32"),
    "negative_binomial": (
        dict(k=K, p=P), _moments(K * (1 - P) / P, K * (1 - P) / P ** 2,
                                 6 / K + P * P / (K * (1 - P))), "float32"),
    "randint": (dict(low=LO, high=HI),
                _moments((LO + HI - 1) / 2, ((HI - LO) ** 2 - 1) / 12,
                         -6 * ((HI - LO) ** 2 + 1)
                         / (5 * ((HI - LO) ** 2 - 1))), "int32"),
    "bernoulli": (dict(p=PB), _moments(PB, PB * (1 - PB),
                                       (1 - 6 * PB * (1 - PB))
                                       / (PB * (1 - PB))), "float32"),
}
SUPPORT = {
    "gamma": lambda x: (x > 0).all(),
    "exponential": lambda x: (x >= 0).all(),
    "poisson": lambda x: (x >= 0).all() and (x == np.round(x)).all(),
    "negative_binomial": lambda x: (x >= 0).all() and (x == np.round(x)).all(),
    "randint": lambda x: ((x >= LO) & (x < HI)).all(),
    "bernoulli": lambda x: np.isin(x, (0, 1)).all(),
}


def _draw(pkg, name, seed, n=N):
    kw, _, _ = CASES[name]
    if pkg == "port":
        mx.random.seed(seed)
        with mx.cpu():
            return getattr(mx.nd.random, name)(shape=(n,), **kw).asnumpy()
    jmx.random.seed(seed)
    return getattr(jmx.nd.random, name)(shape=(n,), **kw).asnumpy()


def _z(x, moments):
    mean, var, var4 = moments
    x = x.astype(np.float64)
    return {"mean": (x.mean() - mean) / math.sqrt(var / x.size),
            "var": (x.var() - var) / math.sqrt(var4 / x.size)}


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sampler_support_dtype_and_moments(name, pkg):
    _, moments, dtype = CASES[name]
    x = _draw(pkg, name, seed=7)
    assert x.shape == (N,) and x.dtype == np.dtype(dtype)
    assert SUPPORT[name](x)
    z = _z(x, moments)
    assert max(abs(v) for v in z.values()) < SIGMAS, z


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_and_jax_sample_means_agree(name):
    _, (mean, var, _), _ = CASES[name]
    got, want = _draw("port", name, 3), _draw("jax", name, 3)
    se = math.sqrt(2 * var / N)
    assert abs(got.astype(np.float64).mean()
               - want.astype(np.float64).mean()) < SIGMAS * se


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_seed_repeats_its_draws(name):
    a, b = _draw("port", name, 11, 4096), _draw("port", name, 11, 4096)
    c = _draw("port", name, 12, 4096)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
@pytest.mark.parametrize("rows", [None, 6])
def test_multinomial_shapes_and_frequencies_match_jax(shape, rows):
    rs = np.random.RandomState(0)
    p = rs.rand(8).astype(np.float32) + 0.1
    probs = p / p.sum() if rows is None else np.tile(p / p.sum(), (rows, 1))
    mx.random.seed(1)
    jmx.random.seed(1)
    with mx.cpu():
        got = mx.nd.random.multinomial(mx.nd.array(probs), shape=shape)
    want = jmx.nd.random.multinomial(jmx.nd.array(probs), shape=shape)
    assert got.shape == want.shape
    assert got.asnumpy().dtype == want.asnumpy().dtype == np.int32
    # unnormalised weights: the same frequencies, 6 standard errors
    with mx.cpu():
        many = mx.nd.random.multinomial(mx.nd.array(p * 3),
                                        shape=(N,)).asnumpy()
    jmany = jmx.nd.random.multinomial(jmx.nd.array(p * 3),
                                      shape=(N,)).asnumpy()
    q = p / p.sum()
    for x in (many, jmany):
        freq = np.bincount(x, minlength=8) / N
        assert (np.abs(freq - q) < SIGMAS * np.sqrt(q * (1 - q) / N)).all()


def test_multinomial_get_prob_is_mxnets_second_output():
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    mx.random.seed(2)
    with mx.cpu():
        draws, logp = mx.nd.random.multinomial(mx.nd.array(probs),
                                               shape=(10,), get_prob=True)
    d = draws.asnumpy()
    np.testing.assert_allclose(
        logp.asnumpy(), np.log(np.take_along_axis(probs, d, 1)), rtol=1e-6)
    # the JAX op ignores get_prob and returns the draws alone
    jout = jmx.nd.random.multinomial(jmx.nd.array(probs), shape=(10,),
                                     get_prob=True)
    assert not isinstance(jout, (list, tuple)) and jout.shape == (2, 10)


def test_shuffle_permutes_rows_whole_as_the_jax_package_does():
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    mx.random.seed(4)
    jmx.random.seed(4)
    with mx.cpu():
        got = mx.nd.random.shuffle(mx.nd.array(x)).asnumpy()
    want = jmx.nd.random.shuffle(jmx.nd.array(x)).asnumpy()
    for out in (got, want):
        assert out.shape == x.shape
        np.testing.assert_array_equal(np.sort(out[:, 0]), x[:, 0])
        np.testing.assert_array_equal(out[:, 1:] - out[:, :1],
                                      x[:, 1:] - x[:, :1])
    assert not np.array_equal(got, x)


def test_samplers_draw_on_the_context_and_fill_out():
    with mx.cpu():
        out = mx.nd.zeros((3, 2))
        got = mx.nd.random.gamma(2.0, 1.0, shape=(3, 2), out=out)
        assert got is out and (out.asnumpy() > 0).all()
        x = mx.nd.random.randint(0, 5, shape=4, dtype="int64")
        assert x.shape == (4,) and x.asnumpy().dtype == np.int64
        assert mx.nd.random.poisson(2.0, shape=(2,), dtype="float64") \
            .asnumpy().dtype == np.float64


def test_sampler_ops_are_registered_as_in_the_jax_package():
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as reg

    names = ["_random_gamma", "_random_exponential", "_random_poisson",
             "_random_negative_binomial", "_random_randint",
             "_sample_multinomial", "_shuffle", "_random_bernoulli"]
    for n in names:
        reg.get(n)
        jreg.get(n)
    assert reg.num_outputs("_sample_multinomial", 1, {"get_prob": True}) == 2
    assert reg.num_outputs("_sample_multinomial", 1, {}) == 1
