"""Random Fourier features and pathwise sampling in the PyTorch port: the
feature map and the Matheron-rule draws against the JAX package fed the
same random numbers (float64, CPU), the Marsaglia–Tsang Gamma sampler's
moments, and the ports of ``tests/test_rff.py``. Tolerances are stated per
test.
"""
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.models import rff as jrff
from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
from gaussianprocessfundamentals_tpu_torch.models import rff as trff

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)

LEAVES = [
    (gpf.SquaredExponentialKernel(), gpt.SquaredExponentialKernel(),
     {"lengthscale": 0.3}),
    (gpf.Matern32Kernel(), gpt.Matern32Kernel(), {"lengthscale": 0.3}),
    (gpf.Matern52Kernel(scaled=True), gpt.Matern52Kernel(scaled=True),
     {"lengthscale": 0.25, "variance": 1.3}),
]
IDS = ["SE", "M32", "M52~s"]


def _installed(leaf, params):
    return gpt.params_from_numpy(leaf, {k: np.float64(v)
                                        for k, v in params.items()})


def _jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("jk,tk,params", LEAVES, ids=IDS)
def test_rff_features_match_jax(jk, tk, params):
    """φ(x) of the JAX package's state carried across, rtol 1e-12."""
    state = jrff.rff_init(jk, _jparams(params), 2, 64, jr.PRNGKey(1))
    x = np.random.default_rng(0).uniform(0, 1, (30, 2))
    got = trff.rff_features(gpt.rff_state_from_numpy(state),
                            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jrff.rff_features(
        state, jnp.asarray(x))), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("jk,tk,params", [LEAVES[0], LEAVES[2]],
                         ids=["SE", "M52~s"])
def test_pathwise_from_draws_matches_jax(jk, tk, params):
    """``pathwise_from_draws`` fed the JAX function's draws -- the state
    from ``rff_init(k_rff)``, w from ``fold_in(key, 1)``, ε from ``k_eps``
    (``rff.py:87-96``) -- against ``pathwise_posterior_samples``: 6 paths
    at 25 points from n = 200, D = 256, 200 CG iterations; max|diff| ≤
    1e-8·max|ref| (a 200-step CG in float64 on σ² = 0.04)."""
    x, y = gpf.synth_se(n=200, lengthscale=0.25, noise_sd=0.2, seed=0)
    xs = np.linspace(0, 1, 25)[:, None]
    key, s, D, noise = jr.PRNGKey(5), 6, 256, 0.04
    jp = _jparams(params)
    ref = np.asarray(jrff.pathwise_posterior_samples(
        jk, jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xs), noise, key,
        num_samples=s, num_features=D, max_iters=200))
    k_rff, k_eps = jr.split(key)
    state = jrff.rff_init(jk, jp, 1, D, k_rff)
    w = np.array(jr.normal(jr.fold_in(key, 1), (D, s), jnp.float64))
    eps = np.array(jr.normal(k_eps, (s, 200), jnp.float64))
    got = trff.pathwise_from_draws(
        _installed(tk, params), torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(xs), noise, gpt.rff_state_from_numpy(state),
        torch.from_numpy(w), torch.from_numpy(eps), max_iters=200).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-8 * np.max(np.abs(ref))


@pytest.mark.parametrize("alpha", [1.5, 2.5])
def test_gamma_marsaglia_tsang_moments(alpha):
    """Gamma(α, 1) by Marsaglia–Tsang, 200,000 draws: the mean α within
    4·√(α/N) and the variance α within 4 standard errors,
    4·α·√((2 + 6/α)/N) (the Gamma's excess kurtosis is 6/α)."""
    n = 200_000
    v = trff.gamma_marsaglia_tsang(
        alpha, (n,), torch.Generator().manual_seed(0),
        torch.zeros((), dtype=torch.float64))
    assert v.shape == (n,) and bool((v > 0).all())
    assert abs(float(v.mean()) - alpha) < 4 * np.sqrt(alpha / n)
    assert abs(float(v.var()) - alpha) < 4 * alpha * np.sqrt(
        (2 + 6 / alpha) / n)


@pytest.mark.parametrize("leaf", [gpt.SquaredExponentialKernel,
                                  gpt.Matern32Kernel, gpt.Matern52Kernel],
                         ids=["SE", "M32", "M52"])
def test_rff_gram_approximation(leaf):
    """Port of ``tests/test_rff.py::test_rff_gram_approximation``: 8,192
    features reproduce the Gram within 0.08."""
    tk = _installed(leaf(), {"lengthscale": 0.3})
    x = torch.linspace(0, 1, 40, dtype=torch.float64)[:, None]
    st = gpt.rff_init(tk, 1, 8192, torch.Generator().manual_seed(0))
    phi = gpt.rff_features(st, x)
    err = float((phi @ phi.T - tk.gram(x, x)).abs().max())
    assert err < 0.08, err


def test_rff_prior_sample_moments():
    """Port of ``tests/test_rff.py::test_rff_prior_sample_moments``: the
    covariance of 4,000 prior draws within 0.12 of the Gram."""
    x = torch.linspace(0, 1, 30, dtype=torch.float64)[:, None]
    k = _installed(gpt.SquaredExponentialKernel(), {"lengthscale": 0.25})
    g = torch.Generator().manual_seed(0)
    st = gpt.rff_init(k, 1, 4096, g)
    s = gpt.rff_prior_sample(st, x, g, 4000).numpy()
    np.testing.assert_allclose(np.cov(s.T), k.gram(x, x).numpy(), atol=0.12)


def test_pathwise_posterior_moments():
    """Port of ``tests/test_rff.py::test_pathwise_posterior_moments``: 600
    paths' mean within 0.08 and variance within 0.05 of the dense
    posterior."""
    x, y = gpf.synth_se(n=120, lengthscale=0.25, noise_sd=0.2, seed=0)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    xs = torch.linspace(0, 1, 25, dtype=torch.float64)[:, None]
    k = _installed(gpt.SquaredExponentialKernel(), {"lengthscale": 0.25})
    noise = 0.04
    samples = gpt.pathwise_posterior_samples(
        k, x, y, xs, noise, torch.Generator().manual_seed(0),
        num_samples=600, num_features=4096, max_iters=200).numpy()
    st = chol.factor(k.gram(x, x), y, noise, 1e-8)
    mu = chol.posterior_mean(st, k.gram(x, xs)).numpy()
    var = chol.posterior_var(st, k.gram(x, xs), k.diag(xs)).numpy()
    np.testing.assert_allclose(samples.mean(0), mu, atol=0.08)
    np.testing.assert_allclose(samples.var(0), var, atol=0.05)


def test_rff_unsupported_kernel_raises():
    """Port of ``tests/test_rff.py::test_rff_unsupported_kernel_raises``."""
    k = _installed(gpt.PeriodicKernel(), {"lengthscale": 0.3, "period": 0.3})
    with pytest.raises(NotImplementedError):
        gpt.rff_init(k, 1, 16, torch.Generator().manual_seed(0))
