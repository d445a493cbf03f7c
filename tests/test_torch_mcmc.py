"""HMC and the chain diagnostics in the PyTorch port against the JAX
package, on the CPU in float64.

``hmc()`` takes its random numbers from a draw source; here the source
replays the JAX package's keys (``hmc.py:81-83``: split(key) into the
momentum key, split once per leaf, and the accept uniform in the default
float dtype; warmup keys from fold_in(key, 0), sampling from
fold_in(key, 1)), so the samples, acceptance probabilities, step size and
log-probs must agree within 1e-9 (``|a − b| ≤ 1e-9·max(1, |b|)``) on a
2-D Gaussian and on the Matérn-5/2 GP hyperposterior at n = 64. The
leapfrog integrator is held to the JAX one, split-R̂ and ESS to 1e-12 on a
fixed [4, 500] array, and ``hmc_chains`` recovers a standard normal.
"""
from functools import partial

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.fit.fit import init_uparams as jinit
from gaussianprocessfundamentals_tpu.fit.fit import make_nll as jmake_nll
from gaussianprocessfundamentals_tpu.mcmc import hmc as jhmc
from gaussianprocessfundamentals_tpu_torch.fit.fit import init_uparams
from gaussianprocessfundamentals_tpu_torch.mcmc import hmc as thmc
from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)

TOL = 1e-9


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.all(np.abs(got - ref) <= tol * np.maximum(1.0, np.abs(ref))), (
        np.max(np.abs(got - ref)))


def _hmc_replay(key, q0_tree, num_warmup, num_samples):
    """The draw source of one ``hmc()`` chain: transition t's momentum and
    accept uniform from the JAX package's key for it."""
    leaves = jax.tree_util.tree_leaves(q0_tree)
    keys = jnp.concatenate([jr.split(jr.fold_in(key, 0), num_warmup),
                            jr.split(jr.fold_in(key, 1), num_samples)])

    @jax.jit
    def draws(k):
        key_mom, key_acc = jr.split(k)
        ks = jr.split(key_mom, len(leaves))
        mom = jnp.concatenate([jr.normal(kk, jnp.shape(l), jnp.float64)
                               .reshape(-1) for kk, l in zip(ks, leaves)])
        return mom, jr.uniform(key_acc, ())

    mom, u = (np.asarray(a) for a in jax.vmap(draws)(keys))
    return lambda t: (torch.from_numpy(mom[t].copy())[None],
                      torch.from_numpy(u[t:t + 1].copy()))


def _gp_targets(n=64):
    x, y = gpf.synth_se(n=n, lengthscale=0.2, noise_sd=0.1, seed=0)
    jnll = jmake_nll(gpf.Matern52Kernel(scaled=True), gpf.ZeroMean(),
                     jnp.asarray(x), jnp.asarray(y), optimize_noise=True)
    tnll = gpt.make_nll(gpt.Matern52Kernel(scaled=True), gpt.ZeroMean(),
                        torch.from_numpy(x), torch.from_numpy(y),
                        optimize_noise=True)

    def jlp(u):
        return -jnll(u) - 0.5 * sum(
            jnp.sum(l ** 2) for l in jax.tree_util.tree_leaves(u)) / 9.0

    def tlp(u):
        return -tnll(u) - 0.5 * sum(torch.sum(l ** 2)
                                    for l in tree_leaves(u)) / 9.0

    ju0 = jinit(gpf.Matern52Kernel(scaled=True), gpf.ZeroMean(),
                [[0.0, 1.0]], n, optimize_noise=True, dtype=jnp.float64)
    tu0 = init_uparams(gpt.Matern52Kernel(scaled=True), gpt.ZeroMean(),
                       [[0.0, 1.0]], n, dtype=torch.float64,
                       optimize_noise=True)
    return jlp, tlp, ju0, tu0


def _gauss_targets():
    """N(0, diag(1, 4)): the gradient is elementwise, so the two packages'
    rounding differs only in the sums of two terms; dual averaging feeds
    any difference back through the step size."""
    var = np.array([1.0, 4.0])
    jv, tv = jnp.asarray(var), torch.from_numpy(var)
    return (lambda q: -0.5 * jnp.sum(q["x"] ** 2 / jv),
            lambda q: -0.5 * torch.sum(q["x"] ** 2 / tv),
            {"x": jnp.asarray([1.0, -2.0])},
            {"x": torch.tensor([1.0, -2.0], dtype=torch.float64)})


def test_leapfrog_matches_jax():
    """12 leapfrog steps of the GP hyperposterior from the defaults with a
    fixed momentum, on the tree state (q and p are trees in both)."""
    jlp, tlp, ju0, tu0 = _gp_targets()
    jp = jax.tree_util.tree_map(lambda l: 0.3 * jnp.ones_like(l), ju0)
    tp = tree_map(lambda l: torch.full_like(l, 0.3), tu0)
    jq, jpo = jhmc.leapfrog(jax.value_and_grad(jlp), ju0, jp, 0.05, 12)

    def tlpg(q):
        with torch.enable_grad():
            req = [l.detach().requires_grad_(True) for l in tree_leaves(q)]
            lp = tlp(tree_unflatten(q, req))
            grads = torch.autograd.grad(lp, req)
        return lp.detach(), tree_unflatten(q, list(grads))

    tq, tpo = thmc.leapfrog(tlpg, tu0, tp, 0.05, 12)
    for a, b in ((tq, jq), (tpo, jpo)):
        for name in ("lengthscale", "variance"):
            _close(a["kernel"][name], b["kernel"][name])
        _close(a["log_noise"], b["log_noise"])


@pytest.mark.parametrize("target", ["gauss2d", "gp64"])
def test_hmc_matches_jax(target):
    """``hmc()`` with 20 warmup and 20 draws, 8 leapfrog steps, from the
    same start and keys."""
    if target == "gp64":
        jlp, tlp, jq0, tq0 = _gp_targets()
    else:
        jlp, tlp, jq0, tq0 = _gauss_targets()
    key = jr.PRNGKey(4)
    ref = jax.jit(partial(jhmc.hmc, jlp, num_samples=20, num_warmup=20,
                          num_leapfrog=8))(jq0, key)
    got = gpt.hmc(tlp, tq0, _hmc_replay(key, jq0, 20, 20), num_samples=20,
                  num_warmup=20, num_leapfrog=8)
    for a, b in zip(jax.tree_util.tree_leaves(ref.samples),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(lambda t: t.numpy(),
                                               got.samples))):
        _close(b, a)
    _close(got.accept_prob, ref.accept_prob)
    _close(got.step_size, ref.step_size)
    _close(got.log_probs, ref.log_probs)
    # the run moved and both accepted and rejected somewhere
    assert 0.0 < float(ref.accept_prob.min()) < 1.0


def test_diagnostics_match_jax():
    """Split-R̂ and ESS (max_lag 100 and 200) of a fixed [4, 500] array of
    AR(1) chains with offset means, within 1e-12."""
    rng = np.random.default_rng(0)
    x = np.zeros((4, 500))
    for t in range(1, 500):
        x[:, t] = 0.7 * x[:, t - 1] + rng.standard_normal(4)
    x += np.array([0.0, 0.1, -0.2, 0.3])[:, None]
    _close(gpt.potential_scale_reduction(torch.from_numpy(x)),
           jhmc.potential_scale_reduction(jnp.asarray(x)), 1e-12)
    jess = jax.jit(jhmc.effective_sample_size, static_argnames="max_lag")
    for lag in (100, 200):
        _close(gpt.effective_sample_size(torch.from_numpy(x), max_lag=lag),
               jess(jnp.asarray(x), max_lag=lag), 1e-12)


def test_hmc_chains_standard_normal():
    """Port of ``test_hmc_chains_and_diagnostics``: 4 chains from spread
    starts on N(2, 0.25·I); R̂ < 1.2, ESS > 50, mean within 0.2 of 2; then
    N(0, I) in 3-D: means within 0.15 of 0 and sds within 0.15 of 1."""
    g = torch.Generator().manual_seed(0)
    q0s = {"x": torch.tensor([[0.0, 0.0], [1.0, 1.0], [-1.0, -1.0],
                              [2.0, 2.0]], dtype=torch.float64)}
    res = gpt.hmc_chains(
        lambda q: -0.5 * torch.sum((q["x"] - 2.0) ** 2, dim=-1) / 0.25,
        q0s, g, num_samples=500, num_warmup=300, num_leapfrog=8)
    trace = res.samples["x"][..., 0]
    assert float(gpt.potential_scale_reduction(trace)) < 1.2
    assert float(gpt.effective_sample_size(trace)) > 50
    assert abs(float(trace.mean()) - 2.0) < 0.2
    res = gpt.hmc_chains(lambda q: -0.5 * torch.sum(q["x"] ** 2, dim=-1),
                         {"x": torch.zeros(4, 3, dtype=torch.float64)}, g,
                         num_samples=500, num_warmup=300, num_leapfrog=8)
    s = res.samples["x"].reshape(-1, 3).numpy()
    assert 0.5 < float(res.accept_prob.mean()) < 1.0
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(s.std(0), 1.0, atol=0.15)
