"""The port's float64 Toeplitz/FFT posterior oracle against the JAX
package's module, and a CPU rehearsal of the 50k variance gate
(``benchmarks/check_pallas_tpu.py:397-431``, ``chip_smoke.py`` runs it at
n = 50,000 on the card) at n = 2,000."""
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.utils import toeplitz_oracle as jax_oracle
from gaussianprocessfundamentals_tpu_torch.utils import toeplitz_oracle as oracle

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)


def _gate_problem(n, lengthscale=0.05, noise=1e-2):
    """The gate's problem at n rows: the grid i/(n−1), 32 test points and
    y = sin(6πx) + 0.1ε from ``default_rng(1)``."""
    rng = np.random.default_rng(1)
    xs = rng.uniform(0.05, 0.95, 32)
    grid = np.arange(n) / (n - 1)
    y = np.sin(2 * np.pi * 3 * grid) + 0.1 * rng.standard_normal(n)
    return grid, xs, y, lengthscale, noise


@pytest.mark.parametrize("n", [257, 2000])
def test_oracle_matches_the_jax_module(n):
    """Each piece and the whole posterior, rtol 1e-12 (the same numpy
    arithmetic)."""
    grid, xs, y, ls, noise = _gate_problem(n)
    h = 1.0 / (n - 1)
    col = oracle.se_first_column(n, h, ls)
    np.testing.assert_allclose(col, jax_oracle.se_first_column(n, h, ls),
                               rtol=1e-12)
    V = np.random.default_rng(2).standard_normal((n, 3))
    np.testing.assert_allclose(oracle.toeplitz_matvec_factory(col)(V),
                               jax_oracle.toeplitz_matvec_factory(col)(V),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        oracle.strang_precond_factory(col, noise)(V),
        jax_oracle.strang_precond_factory(col, noise)(V), rtol=1e-12,
        atol=1e-12)
    got = oracle.se_grid_posterior_oracle(n, ls, noise, xs, y)
    ref = jax_oracle.se_grid_posterior_oracle(n, ls, noise, xs, y)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(b)))
    assert got[2] < 1e-10
    # the Toeplitz product is the dense one
    if n == 257:
        K = np.exp(-0.5 * ((grid[:, None] - grid[None, :]) / ls) ** 2)
        np.testing.assert_allclose(oracle.toeplitz_matvec_factory(col)(V),
                                   K @ V, atol=1e-12)


def test_variance_gate_rehearsal():
    """The port's ``iterative_posterior`` (float64, the gate's knobs:
    max_iters=100, tol=1e-7, precond_m=256) against the oracle at n =
    2,000: max|var − var_oracle| < 1e-3 (k_ii = 1), the oracle's own
    relative residual < 1e-10."""
    n = 2000
    grid, xs, y, ls, noise = _gate_problem(n)
    mu_t, var_t, orc_rel = oracle.se_grid_posterior_oracle(n, ls, noise, xs, y)
    assert orc_rel < 1e-10
    k = gpt.SquaredExponentialKernel().set_params(
        {"lengthscale": torch.tensor(ls, dtype=torch.float64)})
    mu, var = gpt.iterative_posterior(
        k, torch.from_numpy(grid)[:, None], torch.from_numpy(y),
        torch.from_numpy(xs)[:, None], noise, max_iters=100, tol=1e-7,
        precond_m=256)
    assert float(np.max(np.abs(var.numpy() - var_t))) < 1e-3
    assert float(np.max(np.abs(mu.numpy() - mu_t))) < 1e-3
