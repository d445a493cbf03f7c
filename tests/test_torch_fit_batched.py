"""Batched (instance-stacked) input to ``fit`` in the PyTorch port against
the JAX package, in float64 on the CPU: one parameter set shared by the
instances, fitted to the mean of their NLLs. The JAX package needs an
explicit ``xrange`` for batched input (without one it fails with an
IndexError, ROADMAP.md §3 item 4); the port takes the x-range over every
row of every instance. Tolerances are stated per test.
"""
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.fit import fit as jax_fit_mod
from gaussianprocessfundamentals_tpu_torch.config import GPConfig
from gaussianprocessfundamentals_tpu_torch.fit import fit as fit_mod
from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)

B, N = 3, 50
XRANGE = [[0.0, 1.0]]


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1, (B, N, 1)), axis=1)
    y = np.sin(6 * x[..., 0]) + 0.5 + 0.1 * rng.standard_normal((B, N))
    return x, y


def _fits(**kw):
    """(JAX FitResult, port FitResult) of SE~s + Constant on the batch."""
    x, y = _data()
    jres = jax_fit_mod.fit(gpf.SquaredExponentialKernel(scaled=True),
                           jnp.asarray(x), jnp.asarray(y),
                           mean=gpf.ConstantMean(), optimize_noise=True,
                           xrange=XRANGE, **kw)
    tres = gpt.fit(gpt.SquaredExponentialKernel(scaled=True),
                   torch.from_numpy(x), torch.from_numpy(y),
                   mean=gpt.ConstantMean(), optimize_noise=True,
                   xrange=XRANGE, **kw)
    return jres, tres


def _params(res):
    return ([float(t) for t in tree_leaves(res.kernel_params)]
            + [float(t) for t in tree_leaves(res.mean_params)]
            + [float(res.noise)])


def test_batched_adam_matches_jax():
    """30 Adam steps: the per-step NLL history (the mean over instances)
    and the fitted parameters within rtol 1e-8."""
    jres, tres = _fits(method="adam", steps=30, lr=0.05)
    np.testing.assert_allclose(tres.history.numpy(), np.asarray(jres.history),
                               rtol=1e-8)
    np.testing.assert_allclose(_params(tres), _params(jres), rtol=1e-8)


@pytest.mark.parametrize("kw", [{}, {"enforce_bounds": True}],
                         ids=["plain", "bounds"])
def test_batched_lbfgs_reaches_the_jax_optimum(kw):
    """L-BFGS takes another path (strong Wolfe here, zoom there) to the
    same optimum: the final NLL within rtol 1e-7, the parameters within
    rtol 1e-3, the start's NLL within 1e-10."""
    jres, tres = _fits(method="lbfgs", **kw)
    assert tres.nll_post < tres.nll_pre
    np.testing.assert_allclose(tres.nll_pre, jres.nll_pre, rtol=1e-10)
    np.testing.assert_allclose(tres.nll_post, jres.nll_post, rtol=1e-7)
    np.testing.assert_allclose(_params(tres), _params(jres), rtol=1e-3)


def test_batched_restarts_reach_the_jax_optimum():
    """Two random restarts (the packages draw different starts): the best
    final NLL within rtol 1e-7 of the JAX package's, one loss per start."""
    jres = jax_fit_mod.fit(gpf.SquaredExponentialKernel(scaled=True),
                           *map(jnp.asarray, _data()), method="lbfgs",
                           optimize_noise=True, xrange=XRANGE, restarts=2,
                           key=jr.PRNGKey(0))
    tres = gpt.fit(gpt.SquaredExponentialKernel(scaled=True),
                   *map(torch.from_numpy, _data()), method="lbfgs",
                   optimize_noise=True, xrange=XRANGE, restarts=2,
                   generator=torch.Generator().manual_seed(0))
    assert tres.restart_losses.shape == (3,)
    np.testing.assert_allclose(tres.nll_post, jres.nll_post, rtol=1e-7)


def test_batched_nll_is_the_mean_of_the_instance_nlls():
    """``make_nll`` on [B, N] input equals the mean of the B single-instance
    NLLs (rtol 1e-12) and the JAX package's batched NLL (rtol 1e-8: XLA's
    CPU exp is not float64-accurate, and the NLL of -21 sums terms ~1e2)."""
    x, y = _data()
    u = {"kernel": {"lengthscale": torch.tensor(np.log(0.2)),
                    "variance": torch.tensor(np.log(0.7))},
         "mean": {"c": torch.tensor(0.3)},
         "log_noise": torch.tensor(np.log(0.02))}

    def nll(xx, yy):
        return float(fit_mod.make_nll(
            gpt.SquaredExponentialKernel(scaled=True), gpt.ConstantMean(),
            torch.from_numpy(xx), torch.from_numpy(yy),
            optimize_noise=True)(u))

    batched = nll(x, y)
    np.testing.assert_allclose(
        batched, np.mean([nll(x[i], y[i]) for i in range(B)]), rtol=1e-12)
    ju = {"kernel": {k: jnp.asarray(float(v))
                     for k, v in u["kernel"].items()},
          "mean": {"c": jnp.asarray(0.3)},
          "log_noise": jnp.asarray(np.log(0.02))}
    ref = jax_fit_mod.make_nll(gpf.SquaredExponentialKernel(scaled=True),
                               gpf.ConstantMean(), jnp.asarray(x),
                               jnp.asarray(y), optimize_noise=True)(ju)
    np.testing.assert_allclose(batched, float(ref), rtol=1e-8)


def test_batched_xrange_defaults_to_every_row():
    """Without ``xrange`` the port takes the range over every row of every
    instance (the same fit as with that range given, rtol 1e-12), where the
    JAX package indexes a per-row range as [d, 2] and fails."""
    x, y = _data()
    rows = x.reshape(-1, 1)
    xr = [[rows.min(), rows.max()]]
    with pytest.raises(IndexError):
        jax_fit_mod.fit(gpf.SquaredExponentialKernel(scaled=True),
                        jnp.asarray(x), jnp.asarray(y), method="adam",
                        steps=2)
    got, given = (gpt.fit(gpt.SquaredExponentialKernel(scaled=True),
                          torch.from_numpy(x), torch.from_numpy(y),
                          method="lbfgs", optimize_noise=True, **kw)
                  for kw in ({}, {"xrange": xr}))
    assert np.isfinite(got.nll_post) and got.nll_post < got.nll_pre
    np.testing.assert_allclose(_params(got), _params(given), rtol=1e-12)


def test_batched_routing():
    """Batched input stays on the dense route: its working set counts every
    instance, and over the budget it raises (the iterative route takes one
    instance), naming the reason; so do the k-fold and approximation
    objectives."""
    x, y = (torch.from_numpy(a) for a in _data())
    k = gpt.SquaredExponentialKernel()
    one = 3 * N * N * 8  # one instance's working set
    cfg = GPConfig(dense_hbm_budget=2 * one)
    assert np.isfinite(gpt.fit(k, x[0], y[0], config=cfg).nll_post)
    with pytest.raises(ValueError, match="batched"):
        gpt.fit(k, x, y, config=cfg, method="auto", optimize_noise=True)
    for kw in ({"kfold": 3, "generator": torch.Generator().manual_seed(0)},
               {"approximation": "nystroem"}):
        with pytest.raises(ValueError, match="one instance"):
            gpt.fit(k, x, y, **kw)
