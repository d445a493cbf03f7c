"""The port's posterior routes against the JAX package's, in float64, and the
whole slice: a GP saved by the JAX package, loaded by the port, served
through the port's facade."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.models.exact import (
    _posterior_dense as jax_posterior_dense,
)
from gaussianprocessfundamentals_tpu.models.iterative import (
    iterative_posterior_chunked as jax_iterative_posterior_chunked,
)
from gaussianprocessfundamentals_tpu.utils import checkpoint as jax_checkpoint
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# The suite runs one pytest-xdist worker per core: torch's own thread pool
# on top of that oversubscribes the CPU and slows every worker.
torch.set_num_threads(1)

NOISE = 1e-2


def _data(n, t, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1, (n, 1)), 0)
    y = np.sin(8 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    xt = np.linspace(-0.05, 1.05, t)[:, None]
    return x, y, xt


def _kernels(name="SquaredExponentialKernel", scaled=True):
    jk = getattr(gpf, name)(scaled=scaled)
    jp = {"lengthscale": jnp.asarray(0.12)}
    if scaled:
        jp["variance"] = jnp.asarray(1.3)
    tk = gpt.kernel_from_dict(jk.to_dict())
    gpt.params_from_numpy(tk, {k: np.asarray(v) for k, v in jp.items()})
    return jk, jp, tk


def test_iterative_posterior_chunked_matches_jax():
    x, y, xt = _data(600, 50)
    jk, jp, tk = _kernels()
    mu_j, var_j = jax_iterative_posterior_chunked(
        jk, jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt), NOISE,
        chunk=16,
    )
    stats = {}
    # 50 test points in chunks of 16: the last chunk is padded by 14
    mu_t, var_t = gpt.iterative_posterior_chunked(
        tk, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(xt),
        NOISE, chunk=16, stats=stats,
    )
    mu_j, var_j = np.asarray(mu_j), np.asarray(var_j)
    assert mu_t.shape == (50,) and var_t.shape == (50,)
    np.testing.assert_allclose(mu_t.numpy(), mu_j, rtol=0,
                               atol=1e-6 * np.abs(mu_j).max())
    np.testing.assert_allclose(var_t.numpy(), var_j, rtol=0, atol=1e-6 * 1.3)
    assert len(stats["iters"]) == len(stats["rel_resid"]) == 1 + 4
    assert max(stats["rel_resid"]) < 1e-6


def test_iterative_posterior_forms_agree_with_dense():
    """iterative_posterior (one [y | K_s] solve) and iterative_posterior_mean
    agree with the dense Cholesky posterior."""
    x, y, xt = _data(400, 30, seed=1)
    _, _, tk = _kernels()
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(xt))
    dense = gpt.posterior(tk, *args, NOISE, method="dense")
    mu, var = gpt.iterative_posterior(tk, *args, NOISE)
    mu_only = gpt.iterative_posterior_mean(tk, *args, NOISE)
    torch.testing.assert_close(mu, dense.mean, rtol=0, atol=1e-7)
    torch.testing.assert_close(mu_only, dense.mean, rtol=0, atol=1e-7)
    torch.testing.assert_close(var, dense.var, rtol=0, atol=1e-7)


@pytest.mark.parametrize("full_cov", [False, True])
def test_dense_posterior_matches_jax(full_cov):
    x, y, xt = _data(300, 40, seed=2)
    jk, jp, tk = _kernels("Matern52Kernel", scaled=True)
    ref = jax_posterior_dense(
        jk, jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xt), NOISE, 1e-8,
        gpf.ZeroMean(), {}, full_cov,
    )
    got = gpt.posterior(tk, torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(xt), NOISE, 1e-8, full_cov=full_cov,
                        method="dense")
    if full_cov:
        (ref, ref_cov), (got, got_cov) = ref, got
        np.testing.assert_allclose(got_cov.numpy(), np.asarray(ref_cov),
                                   rtol=0, atol=1e-10)
    for field in ("mean", "var", "sd", "mean_fn_mu", "posterior_mu"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=1e-10, atol=1e-10, err_msg=field)


@pytest.mark.parametrize("name,scaled", [("SquaredExponentialKernel", True),
                                         ("Matern32Kernel", False)])
def test_checkpoint_to_facade_matches_jax(tmp_path, name, scaled):
    """The whole slice: JAX fit state → checkpoint → port facade posterior,
    on the iterative route and through method="auto"."""
    x, y, xt = _data(800, 64, seed=3)
    jk, jp, _ = _kernels(name, scaled)
    path = str(tmp_path / "gp")
    jax_checkpoint.save(path, jk, jp, mean=gpf.ZeroMean(), mean_params={},
                        noise=NOISE)
    jgp = gpf.GaussianProcess(jk, kernel_params=jp, mean_params={},
                              noise=jnp.asarray(NOISE))
    jgp.set_data(jnp.asarray(x), jnp.asarray(y))

    kernel, mean, noise = gpt.load(path)
    assert noise == NOISE and isinstance(mean, gpt.ZeroMean)
    assert kernel.to_dict() == jk.to_dict()
    tgp = gpt.GaussianProcess(kernel, mean, noise=noise, device="cpu")
    tgp.set_data(x, y)
    for method, tol in (("iterative", 1e-6), ("auto", 1e-10)):
        ref = jgp.posterior(jnp.asarray(xt), method=method)
        got = tgp.posterior(xt, method=method)
        assert (got.solve_stats is None) == (method == "auto")
        mu_ref = np.asarray(ref.mean)
        np.testing.assert_allclose(got.mean.numpy(), mu_ref, rtol=0,
                                   atol=tol * np.abs(mu_ref).max())
        np.testing.assert_allclose(got.var.numpy(), np.asarray(ref.var),
                                   rtol=0, atol=tol * (1.3 if scaled else 1.0))
    mu, mean_mu, post_mu = tgp.predict(xt)
    torch.testing.assert_close(mu, post_mu)
    assert (mean_mu == 0).all()


def test_facade_defaults_match_jax():
    """Without set hyperparameters both facades use the kernel defaults
    for the training range and the jitter as noise. With σ² = 1e-8 the
    system's condition number is ~1e8, which scales float64 rounding in the
    two Cholesky factorisations up to ~1e-7."""
    x, y, xt = _data(200, 20, seed=4)
    jgp = gpf.GaussianProcess(gpf.SquaredExponentialKernel())
    jgp.set_data(jnp.asarray(x), jnp.asarray(y))
    tgp = gpt.GaussianProcess(gpt.SquaredExponentialKernel(),
                              device="cpu").set_data(x, y)
    ref = jgp.posterior(jnp.asarray(xt))
    got = tgp.posterior(xt)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean),
                               rtol=1e-5, atol=1e-6)
    assert float(tgp.kernel.lengthscale) == pytest.approx(
        float(jgp.kernel_params["lengthscale"]))


def test_facade_refuses_what_this_slice_does_not_serve():
    tgp = gpt.GaussianProcess(gpt.SquaredExponentialKernel(), device="cpu")
    with pytest.raises(ValueError, match="set_data"):
        tgp.posterior(np.zeros((3, 1)))
    with pytest.raises(ValueError, match="training data"):
        tgp.fit()
    # SciPy's optimisers are served (fit.scipy_run), and batched
    # (instance-stacked) input
    x = np.linspace(0, 1, 12)[:, None]
    res = tgp.fit(x, np.sin(6 * x[:, 0]), method="scipy-bfgs")
    assert np.isfinite(res.nll_post) and res.nll_post <= res.nll_pre
    res = tgp.fit(np.stack([x, x]),
                  np.stack([np.sin(6 * x[:, 0]), np.cos(6 * x[:, 0])]))
    assert np.isfinite(res.nll_post) and res.nll_post <= res.nll_pre
    tgp.set_data(np.zeros((3, 1)), np.zeros(3))
    with pytest.raises(ValueError, match="method"):
        tgp.posterior(np.zeros((2, 1)), method="cholesky")
