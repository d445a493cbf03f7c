"""The dense Gram kernels K5 (``se_gram``) and K6 (``matern_gram``) and the
dense route around them, against the JAX package.

On the CPU the port's wrappers take their plain versions; the JAX kernels
run as ``tests/test_pallas.py`` runs them, in Pallas interpret mode, at its
shapes and tolerances (float32: atol 2e-5, 5e-5 for Matérn). The router
``dense_gram_for``, the dense posterior, the log marginal likelihood and
sampling (with the normal draws shared) are held to the JAX package in
float64. The kernels on the card: ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.fit.fit import (
    init_uparams as jax_init_uparams,
)
from gaussianprocessfundamentals_tpu.fit.fit import make_nll as jax_make_nll
from gaussianprocessfundamentals_tpu.ops.pallas_gram import (
    matern_gram as jax_matern_gram,
)
from gaussianprocessfundamentals_tpu.ops.pallas_gram import (
    se_gram as jax_se_gram,
)
from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
from gaussianprocessfundamentals_tpu_torch.models import exact
from gaussianprocessfundamentals_tpu_torch.ops import cuda_dense_gram as dg
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)


def _x(n, d=1, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, d)).astype(np.float32)


@pytest.mark.parametrize("n,m,d", [(64, 64, 1), (100, 80, 3), (256, 256, 2),
                                   (60, 45, 12)])
def test_se_gram_matches_jax(n, m, d):
    x1, x2 = _x(n, d, 0), _x(m, d, 1)
    got = dg.se_gram(torch.from_numpy(x1), torch.from_numpy(x2), 0.3, 1.5)
    ref = np.asarray(jax_se_gram(jnp.asarray(x1), jnp.asarray(x2), 0.3, 1.5,
                                 interpret=True))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, m)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    assert dg.se_gram.launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("nu", ["32", "52"])
def test_matern_gram_matches_jax(nu, d):
    """The Euclidean Matérn at every d, as the JAX package computes it (the
    leaves' Manhattan form equals it only at d = 1)."""
    x1, x2 = _x(64, d, 0), _x(64, d, 1)
    got = dg.matern_gram(torch.from_numpy(x1), torch.from_numpy(x2), 0.25,
                         0.8, nu=nu)
    ref = np.asarray(jax_matern_gram(jnp.asarray(x1), jnp.asarray(x2), 0.25,
                                     0.8, nu=nu, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)


@pytest.mark.parametrize("diag_add", [0.3, 0.0, -0.2])
@pytest.mark.parametrize("kind", ["se", "32", "52"])
def test_tensor_hyperparameters_match_floats(kind, diag_add):
    """0-d tensors for ℓ, σ² and diag_add give the Gram that floats give; a
    diag_add ≤ 0 adds nothing, as ``pl.when(diag > 0.0)`` on the TPU."""
    x1, x2 = torch.from_numpy(_x(40, 2, 11)), torch.from_numpy(_x(30, 2, 12))
    fn, extra = (dg.se_gram, {}) if kind == "se" else (
        dg.matern_gram, {"nu": kind})
    floats = fn(x1, x2, 0.3, 1.4, diag_add, **extra)
    tensors = fn(x1, x2, torch.tensor(0.3), torch.tensor(1.4),
                 torch.tensor(diag_add), **extra)
    torch.testing.assert_close(tensors, floats, rtol=0, atol=0)
    bare = fn(x1, x2, 0.3, 1.4, **extra)
    if diag_add <= 0.0:
        assert torch.equal(tensors, bare)
    else:
        torch.testing.assert_close((tensors - bare)[:30, :30],
                                   diag_add * torch.eye(30), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,m", [(96, 96), (100, 60), (60, 100)])
def test_diag_add_on_the_global_diagonal(n, m):
    """diag_add lands where row index = column index, on a non-square build
    too, as the TPU kernels place it (``pallas_gram.py:55-63``)."""
    x1, x2 = _x(n, 2, 3), _x(m, 2, 4)
    got = dg.se_gram(torch.from_numpy(x1), torch.from_numpy(x2), 0.3, 1.0,
                     diag_add=0.7)
    ref = np.asarray(jax_se_gram(jnp.asarray(x1), jnp.asarray(x2), 0.3, 1.0,
                                 diag_add=0.7, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    plain = dg.se_gram(torch.from_numpy(x1), torch.from_numpy(x2), 0.3, 1.0)
    k = min(n, m)
    np.testing.assert_allclose((got - plain).numpy()[:k, :k],
                               0.7 * np.eye(k), atol=1e-6)
    # matern too; a non-positive diag_add adds nothing, as on the TPU
    got = dg.matern_gram(torch.from_numpy(x1[:, :1]), torch.from_numpy(x2[:, :1]),
                         0.3, 1.0, diag_add=0.7, nu="32")
    ref = np.asarray(jax_matern_gram(jnp.asarray(x1[:, :1]),
                                     jnp.asarray(x2[:, :1]), 0.3, 1.0,
                                     diag_add=0.7, nu="32", interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)
    assert torch.equal(dg.se_gram(torch.from_numpy(x1), torch.from_numpy(x2),
                                  0.3, 1.0, diag_add=-1.0), plain)


def test_make_nll_gram_fn_override():
    """``make_nll(gram_fn=...)`` with K5, as ``tests/test_misc.py:27-50``
    drives the Pallas kernel: the exact-difference tile Gram against the
    default Gram, rtol 1e-3 for the reason stated there; and the port's
    K5 objective against the JAX package's Pallas one."""
    x, y = gpf.synth_se(n=96, lengthscale=0.2, noise_sd=0.1, seed=0)
    x32, y32 = np.asarray(x, np.float32), np.asarray(y, np.float32)
    k = gpf.SquaredExponentialKernel()
    u = jax_init_uparams(k, gpf.ZeroMean(), [[0.0, 1.0]], 96, dtype=jnp.float32)
    jax_pallas = float(jax_make_nll(
        k, gpf.ZeroMean(), jnp.asarray(x32), jnp.asarray(y32),
        fixed_noise=0.01,
        gram_fn=lambda p, a, b: jax_se_gram(a, b, p["lengthscale"],
                                            interpret=True))(u))

    tk = gpt.SquaredExponentialKernel()
    xt, yt = torch.from_numpy(x32), torch.from_numpy(y32)
    tu = {"kernel": {"lengthscale": torch.tensor(np.asarray(
        u["kernel"]["lengthscale"]))}, "mean": {}}
    default = float(gpt.make_nll(tk, gpt.ZeroMean(), xt, yt,
                                 fixed_noise=0.01)(tu))
    k5 = float(gpt.make_nll(
        tk, gpt.ZeroMean(), xt, yt, fixed_noise=0.01,
        gram_fn=lambda kern, a, b: dg.se_gram(a, b, kern.lengthscale))(tu))
    np.testing.assert_allclose(k5, default, rtol=1e-3)
    np.testing.assert_allclose(k5, jax_pallas, rtol=1e-3)


def _kernels(d):
    se = gpt.SquaredExponentialKernel(dim=d, scaled=True).set_params({
        "lengthscale": torch.tensor([0.3, 0.5][:d], dtype=torch.float64),
        "variance": torch.tensor(1.7, dtype=torch.float64)})
    m52 = gpt.Matern52Kernel(scaled=True).set_params({
        "lengthscale": torch.tensor(0.2, dtype=torch.float64),
        "variance": torch.tensor(0.6, dtype=torch.float64)})
    return {"se-ard": se, "m52": m52}


@pytest.mark.parametrize("route", ["gram", "kernels"])
@pytest.mark.parametrize("name", ["se-ard", "m52"])
def test_router_and_noised_gram_on_the_cpu(name, route, monkeypatch):
    """``kernel.gram`` on the CPU, and the kernels' route (forced here onto
    the wrappers' plain versions), which takes the hyperparameters and the
    noised shift as device tensors, against it."""
    d = 2 if name == "se-ard" else 1
    kernel = _kernels(d)[name]
    x = torch.from_numpy(_x(50, d, 5).astype(np.float64))
    xt = torch.from_numpy(_x(20, d, 6).astype(np.float64))
    # kernel.gram itself on the CPU; the wrappers' direct differences
    # against the leaves' expanded float64 form on the kernels' route
    atol = 1e-15
    if route == "kernels":
        atol = 1e-14
        wrapper = (dg.se_gram, {}) if name == "se-ard" else (
            dg.matern_gram, {"nu": "52"})
        monkeypatch.setattr(dg, "_kernel_route", lambda k, x1: wrapper)
    got = dg.dense_gram_for(kernel, x, xt)
    if route == "gram":
        assert torch.equal(got, kernel.gram(x, xt))
    else:
        torch.testing.assert_close(got, kernel.gram(x, xt), rtol=0,
                                   atol=atol)
    K = kernel.gram(x, x)
    for noise in (0.05, torch.tensor(0.05, dtype=torch.float64)):
        torch.testing.assert_close(dg.noised_gram(kernel, x, noise, 1e-8),
                                   chol.noised(K, 0.05, 1e-8), rtol=0,
                                   atol=atol)
    with pytest.raises(ValueError, match="square"):
        dg.dense_gram_for(kernel, x, xt, 0.1)


def test_router_refuses_hyperparameters_that_require_grad(monkeypatch):
    """On the kernels' route (forced here onto the plain versions) the
    router refuses a kernel whose hyperparameters require grad, unless
    autograd is off; kernel.gram keeps the CPU route differentiable."""
    kernel = _kernels(1)["m52"]
    x = torch.from_numpy(_x(30, 1, 7).astype(np.float64))
    with kernel.differentiable() as p:
        K = dg.dense_gram_for(kernel, x, x)
        K.sum().backward()
        assert p["lengthscale"].grad is not None
        monkeypatch.setattr(dg, "_kernel_route",
                            lambda k, x1: (dg.matern_gram, {"nu": "52"}))
        with pytest.raises(RuntimeError, match="forward-only"):
            dg.dense_gram_for(kernel, x, x)
        with torch.no_grad():
            torch.testing.assert_close(dg.dense_gram_for(kernel, x, x),
                                       kernel.gram(x, x), rtol=0, atol=1e-14)


def _jax_se(d):
    return (gpf.SquaredExponentialKernel(dim=d, scaled=True),
            {"lengthscale": jnp.asarray([0.3, 0.5][:d]),
             "variance": jnp.asarray(1.7)})


def test_log_marginal_likelihood_and_dense_posterior_match_jax():
    x = _x(80, 2, 7).astype(np.float64)
    y = np.sin(4 * x[:, 0]) + x[:, 1]
    xt = _x(15, 2, 8).astype(np.float64)
    jk, jp = _jax_se(2)
    jgp = gpf.GaussianProcess(jk, kernel_params=jp, noise=jnp.asarray(0.03))
    jgp.set_data(jnp.asarray(x), jnp.asarray(y))
    tgp = gpt.GaussianProcess(_kernels(2)["se-ard"], noise=0.03, device="cpu")
    tgp.set_data(x, y)
    np.testing.assert_allclose(float(tgp.log_marginal_likelihood()),
                               float(jgp.log_marginal_likelihood()), rtol=1e-10)
    post, cov = tgp.posterior(xt, full_cov=True)
    jpost, jcov = jgp.posterior(jnp.asarray(xt), full_cov=True)
    np.testing.assert_allclose(post.mean.numpy(), np.asarray(jpost.mean),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), atol=1e-10)


def test_sampling_with_shared_draws_matches_jax():
    """Prior and posterior draws from the same standard-normal z (the JAX
    package's own draws from its key), float64, within 1e-8."""
    x = np.sort(_x(40, 2, 9).astype(np.float64), axis=0)
    y = np.cos(3 * x[:, 0])
    xt = _x(12, 2, 10).astype(np.float64)
    jk, jp = _jax_se(2)
    key = jr.PRNGKey(3)
    tk = _kernels(2)["se-ard"]

    jprior = np.asarray(gpf.sample_prior(jk, jp, jnp.asarray(x), key, 5))
    z = torch.from_numpy(np.array(jr.normal(key, (5, 40), jnp.float64)))
    prior = exact.prior_draws(tk, torch.from_numpy(x), z)
    np.testing.assert_allclose(prior.numpy(), jprior, atol=1e-8)

    jpost = np.asarray(gpf.sample_posterior(
        jk, jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt), 0.02, key, 4))
    z = torch.from_numpy(np.array(jr.normal(key, (4, 12), jnp.float64)))
    post = exact.posterior_draws(tk, torch.from_numpy(x), torch.from_numpy(y),
                                 torch.from_numpy(xt), 0.02, z)
    np.testing.assert_allclose(post.numpy(), jpost, atol=1e-8)

    # the facade draws from a torch.Generator: same shape, finite, seeded
    tgp = gpt.GaussianProcess(tk, noise=0.02, device="cpu").set_data(x, y)
    a = tgp.sample_posterior(xt, torch.Generator().manual_seed(0), 3)
    b = tgp.sample_posterior(xt, torch.Generator().manual_seed(0), 3)
    assert a.shape == (3, 12) and torch.isfinite(a).all() and torch.equal(a, b)
    assert tgp.sample_prior(x, torch.Generator().manual_seed(1), 2).shape == (2, 40)


def test_sampling_escalates_the_jitter_in_float32():
    """A float32 posterior covariance K_ss − vᵀv at dense training data
    carries rounding the raw 1e-8 jitter does not cover; the draw's factor
    takes the first of jitter·10ᵏ that factors, as ``fit`` escalates."""
    x = torch.linspace(0, 1, 400, dtype=torch.float32)[:, None]
    y = torch.sin(6 * x[:, 0])
    k = gpt.SquaredExponentialKernel().set_params(
        {"lengthscale": torch.tensor(0.2)})
    gp = gpt.GaussianProcess(k, noise=1e-4, device="cpu").set_data(x, y)
    draws = gp.sample_posterior(torch.linspace(0, 1, 200)[:, None],
                                torch.Generator().manual_seed(0), 8)
    assert torch.isfinite(draws).all()
