"""NUTS in the PyTorch port against the JAX package, on the CPU in float64.

The port's transition takes its random numbers from a draw source; here
the source replays the JAX package's key schedule (``nuts.py:88``,
``:141``, ``:204``, and the warmup and sampling scans' ``fold_in`` /
``split`` at ``:339-372`` and ``:410``), so a transition, a ``nuts()``
run and a ``nuts_resume()`` run must reproduce the JAX package's: the
leapfrog counts and divergences identical, every float within 1e-9
(``|a − b| ≤ 1e-9·max(1, |b|)``). One batched call of 4 chains that stop
at different depths is held to 4 JAX calls. Then the ports of
``tests/test_nuts.py``'s sampling checks. Every JAX function is jitted
once per target at dim 3 and max_depth 5.
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
from gaussianprocessfundamentals_tpu.fit.fit import make_nll as jmake_nll
from gaussianprocessfundamentals_tpu.mcmc import nuts as jnuts
from gaussianprocessfundamentals_tpu_torch.fit.fit import init_uparams
from gaussianprocessfundamentals_tpu_torch.mcmc import nuts as tnuts
from gaussianprocessfundamentals_tpu_torch.mcmc.hmc import (
    single_chain,
    value_and_grad,
)
from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    ravel_tree,
    tree_leaves,
)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)

MAX_DEPTH = 5
DIM = 3
TOL = 1e-9
SCALES = np.array([0.1, 1.0, 10.0])


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.all(np.abs(got - ref) <= TOL * np.maximum(1.0, np.abs(ref))), (
        np.max(np.abs(got - ref)))


@partial(jax.jit, static_argnums=(1,))
def _draws(key, dim):
    """One transition's draws as ``_nuts_kernel`` makes them: the momentum
    from split(key, 3)[0], then per doubling split(key, 4) → (key, kd, kt,
    km) with the direction uniform in the default float dtype, and per
    leaf split(kt)."""
    key_mom, _, k = jr.split(key, 3)
    mom = jr.normal(key_mom, (dim,), jnp.float64)
    dirs, merges, leaves = [], [], []
    for j in range(MAX_DEPTH):
        k, kd, kt, km = jr.split(k, 4)
        dirs.append(jr.uniform(kd, ()))
        merges.append(jr.uniform(km, (), jnp.float64))
        for _ in range(1 << j):
            kt, sk = jr.split(kt)
            leaves.append(jr.uniform(sk, (), jnp.float64))
    return mom, jnp.stack(dirs), jnp.stack(merges), jnp.stack(leaves)


_draws_many = jax.jit(jax.vmap(_draws, in_axes=(0, None)), static_argnums=(1,))


def _replay(chain_keys):
    """A draw source from C chains' [T] transition keys: transition t of
    chain c takes ``_draws(chain_keys[c][t])``."""
    mom, dirs, merges, leaves = (
        np.stack(a) for a in zip(*(
            [np.asarray(v) for v in _draws_many(jnp.stack(ks), DIM)]
            for ks in chain_keys)))

    def source(t):
        return tnuts.NUTSDraws(torch.from_numpy(mom[:, t]),
                               torch.from_numpy(dirs[:, t].T.copy()),
                               torch.from_numpy(merges[:, t].T.copy()),
                               torch.from_numpy(leaves[:, t].T.copy()))

    return source


def _nuts_keys(key, num_warmup, num_samples):
    """Transition keys of ``nuts()`` in the order the port numbers them."""
    n1 = max(num_warmup // 2, 1)
    n2 = max(num_warmup - n1, 1)
    return jnp.concatenate([jr.split(jr.fold_in(key, 0), n1),
                            jr.split(jr.fold_in(key, 2), n2),
                            jr.split(jr.fold_in(key, 1), num_samples)])


# --- targets: (JAX log-prob of a tree, port log-prob of a tree, q0) ---------

def _gauss_targets():
    s = jnp.asarray(SCALES)
    st = torch.from_numpy(SCALES)
    return (lambda q: -0.5 * jnp.sum((q["x"] / s) ** 2),
            lambda q: -0.5 * torch.sum((q["x"] / st) ** 2, dim=-1),
            {"x": np.array([0.05, -0.8, 4.0])})


def _gp_problem(n=64):
    x, y = gpf.synth_se(n=n, lengthscale=0.2, noise_sd=0.1, seed=0)
    jk = gpf.Matern52Kernel(scaled=True)
    jnll = jmake_nll(jk, gpf.ZeroMean(), jnp.asarray(x), jnp.asarray(y),
                     optimize_noise=True)

    def jlp(u):
        return -jnll(u) - 0.5 * sum(
            jnp.sum(l ** 2) for l in jax.tree_util.tree_leaves(u)) / 9.0

    return x, y, jlp


def _gp_port(x, y, stacked: bool):
    """The port's log posterior: ``make_stacked_nll`` over chains, or
    ``make_nll`` of one chain."""
    k, m = gpt.Matern52Kernel(scaled=True), gpt.ZeroMean()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    if stacked:
        nll = gpt.make_stacked_nll(k, m, xt, yt, optimize_noise=True)
        return lambda u: -nll(u) - 0.5 * sum(
            (l ** 2).reshape(l.shape[0], -1).sum(-1)
            for l in tree_leaves(u)) / 9.0
    nll = gpt.make_nll(k, m, xt, yt, optimize_noise=True)
    return lambda u: -nll(u) - 0.5 * sum(torch.sum(l ** 2)
                                         for l in tree_leaves(u)) / 9.0


# from the defaults (ℓ 0.1, σ² 0.1, noise 1e-4) to near the posterior's
# mode: ℓ ≈ 0.16, σ² ≈ 0.45, noise ≈ 0.01 (log ℓ, log σ², log noise)
GP_SHIFT = np.array([0.5, 1.5, 4.6])
GP_INV_MASS = np.array([0.1, 0.3, 0.1])


def _gp_u0(n, shift):
    u = init_uparams(gpt.Matern52Kernel(scaled=True), gpt.ZeroMean(),
                     [[0.0, 1.0]], n, dtype=torch.float64,
                     optimize_noise=True)
    flat, unravel = ravel_tree(u)
    return unravel(flat + torch.as_tensor(shift, dtype=torch.float64))


def _jtransition(jlp, q0_tree):
    _, unravel = jax.flatten_util.ravel_pytree(q0_tree)
    lpg = jax.value_and_grad(lambda qf: jlp(unravel(qf)))
    return jax.jit(jnuts._nuts_kernel(lpg, MAX_DEPTH)), lpg


def _port_transition(tlp, q0_tree, stacked=False):
    q, unravel = ravel_tree(q0_tree, batch_ndim=1 if stacked else 0)
    fn = tlp if stacked else single_chain(tlp)
    return value_and_grad(fn, unravel), (q if stacked else q[None])


def _run_transition_case(jlp, tlp, q0_np_tree, q0_t_tree, keys, eps,
                         inv_mass):
    jtrans, jlpg = _jtransition(jlp, q0_np_tree)
    lpg, q = _port_transition(tlp, q0_t_tree)
    qf = jax.flatten_util.ravel_pytree(q0_np_tree)[0]
    lp0, g0 = jlpg(qf)
    tlp0, tg0 = lpg(q)
    _close(tlp0, [lp0])
    _close(tg0[0], g0)
    out = []
    for key in keys:
        ref = [np.asarray(v) for v in
               jtrans(key, qf, lp0, g0, eps, jnp.asarray(inv_mass))]
        got = tnuts.nuts_transition(
            lpg, MAX_DEPTH, _replay([key[None]])(0), q, tlp0, tg0,
            torch.tensor([eps], dtype=torch.float64),
            torch.from_numpy(np.asarray(inv_mass, np.float64))[None])
        assert float(got[4][0]) == float(ref[3]), "n_steps"
        assert bool(got[5][0]) == bool(ref[4]), "diverging"
        _close(got[0][0], ref[0])
        _close(got[1][0], ref[1])
        _close(got[3][0], ref[2])
        out.append((float(ref[3]), bool(ref[4])))
    return out


CASES = ["aniso3d", "diverging", "gp64"]


@pytest.mark.parametrize("case", CASES)
def test_transition_matches_jax(case):
    """Three transitions from three keys at max_depth 5: an anisotropic
    Gaussian (scales 0.1, 1, 10) at ε = 0.15 with a unit mass, the same at
    ε = 1.5 (beyond the 0.2 stability limit of the 0.1 scale: the energy
    error passes 1000 and the transition diverges), and the Matérn-5/2
    GP hyperposterior at n = 64 near its mode at ε = 0.3, inv_mass
    (0.1, 0.3, 0.1)."""
    keys = [jr.PRNGKey(s) for s in (3, 11, 29)]
    if case == "gp64":
        x, y, jlp = _gp_problem()
        u0 = _gp_u0(64, GP_SHIFT)
        ju0 = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), u0)
        got = _run_transition_case(jlp, _gp_port(x, y, False), ju0, u0,
                                   keys, 0.3, GP_INV_MASS)
    else:
        jlp, tlp, q0 = _gauss_targets()
        eps = 0.15 if case == "aniso3d" else 1.5
        got = _run_transition_case(
            jlp, tlp, {"x": jnp.asarray(q0["x"])},
            {"x": torch.from_numpy(q0["x"])}, keys, eps, np.ones(DIM))
    divs = [d for _, d in got]
    assert any(divs) if case == "diverging" else not any(divs)


def test_batched_chains_stop_at_different_depths():
    """4 GP chains (``make_stacked_nll``) in one lock-step call against 4
    JAX transitions, each from its own position, key and step size; the
    chains stop after different numbers of leapfrog steps."""
    x, y, jlp = _gp_problem()
    shifts = GP_SHIFT + np.array([[0.0, 0.0, 0.0], [-0.2, 0.1, 0.2],
                                  [0.1, -0.3, -0.1], [0.2, 0.2, 0.0]])
    eps = np.array([0.05, 0.3, 0.6, 1.0])
    inv_mass = GP_INV_MASS
    keys = [jr.PRNGKey(100 + c) for c in range(4)]
    u0s = [_gp_u0(64, s) for s in shifts]
    flat = torch.stack([ravel_tree(u)[0] for u in u0s])
    unravel = ravel_tree(u0s[0])[1]
    stacked = unravel(flat)
    lpg, q = _port_transition(_gp_port(x, y, True), stacked, stacked=True)
    lp0, g0 = lpg(q)
    got = tnuts.nuts_transition(
        lpg, MAX_DEPTH, _replay([k[None] for k in keys])(0), q, lp0, g0,
        torch.from_numpy(eps), torch.from_numpy(np.tile(inv_mass, (4, 1))))
    ju0 = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), u0s[0])
    jtrans, jlpg = _jtransition(jlp, ju0)
    steps = []
    for c in range(4):
        qf = jnp.asarray(flat[c].numpy())
        jlp0, jg0 = jlpg(qf)
        _close(lp0[c], jlp0)
        _close(g0[c], jg0)
        ref = [np.asarray(v) for v in jtrans(keys[c], qf, jlp0, jg0, eps[c],
                                             jnp.asarray(inv_mass))]
        assert float(got[4][c]) == float(ref[3])
        assert bool(got[5][c]) == bool(ref[4])
        _close(got[0][c], ref[0])
        _close(got[1][c], ref[1])
        _close(got[3][c], ref[2])
        steps.append(float(ref[3]))
    assert len(set(steps)) >= 3, steps


def _jnuts_run(jlp, q0, key, **kw):
    return jax.jit(partial(jnuts.nuts, jlp, **kw))(q0, key)


def _check_result(got, ref):
    assert np.array_equal(got.num_steps.numpy(), np.asarray(ref.num_steps))
    assert np.array_equal(got.diverging.numpy(), np.asarray(ref.diverging))
    _close(got.samples["x"], ref.samples["x"])
    for a, b in ((got.accept_stat, ref.accept_stat),
                 (got.log_probs, ref.log_probs),
                 (got.step_size, ref.step_size),
                 (got.inv_mass, ref.inv_mass)):
        _close(a, b)


def test_nuts_and_resume_match_jax():
    """``nuts()`` with 20 warmup transitions (both phases: 10 at unit mass,
    then the diagonal mass from their moments) and 10 draws, then
    ``nuts_resume()`` for 10 more from the last draw at the frozen step
    size and mass, on the anisotropic Gaussian."""
    jlp, tlp, q0 = _gauss_targets()
    key = jr.PRNGKey(5)
    jq0 = {"x": jnp.asarray(q0["x"])}
    ref = _jnuts_run(jlp, jq0, key, num_samples=10, num_warmup=20,
                     max_depth=MAX_DEPTH)
    got = gpt.nuts(tlp, {"x": torch.from_numpy(q0["x"])},
                   _replay([_nuts_keys(key, 20, 10)]), num_samples=10,
                   num_warmup=20, max_depth=MAX_DEPTH)
    _check_result(got, ref)
    assert float(ref.inv_mass.std()) > 0  # phase 2 ran with a real mass
    key2 = jr.PRNGKey(6)
    jlast = jax.tree_util.tree_map(lambda l: l[-1], ref.samples)
    ref2 = jax.jit(partial(jnuts.nuts_resume, jlp, num_samples=10,
                           max_depth=MAX_DEPTH))(
        jlast, key2, step_size=ref.step_size, inv_mass=ref.inv_mass)
    got2 = gpt.nuts_resume(
        tlp, {"x": got.samples["x"][-1]}, _replay([jr.split(key2, 10)]),
        num_samples=10, step_size=got.step_size, inv_mass=got.inv_mass,
        max_depth=MAX_DEPTH)
    _check_result(got2, ref2)
    assert got.doublings > 0 and got2.doublings > 0


def test_nuts_chains_standard_normal():
    """Port of ``test_nuts_standard_normal`` over 4 chains in lock step:
    means within 0.15 of 0 and sds within 0.15 of 1 (4 × 500 draws), under
    5% divergences, trajectories longer than one step."""
    g = torch.Generator().manual_seed(0)
    res = gpt.nuts_chains(lambda q: -0.5 * torch.sum(q["x"] ** 2, dim=-1),
                          {"x": torch.zeros(4, 4, dtype=torch.float64)}, g,
                          num_samples=500, num_warmup=300, max_depth=6)
    s = res.samples["x"].reshape(-1, 4).numpy()
    np.testing.assert_allclose(s.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(s.std(0), 1.0, atol=0.15)
    assert float(res.diverging.double().mean()) < 0.05
    assert float(res.num_steps.mean()) > 2.0
    assert res.samples["x"].shape == (4, 500, 4)


def test_nuts_chains_gp_hyperposterior():
    """Port of ``test_nuts_chains_gp_hyperposterior``
    (``tests/test_nuts.py:38-65``) on ``make_stacked_nll``: n = 120, 2
    chains from random points inside the bounds, 400 warmup and 250 draws
    at max_depth 6; finite log-probs, < 20% divergences, mean lengthscale
    in (0.02, 1.5), split-R̂ of log ℓ < 1.45."""
    x, y = gpf.synth_se(n=120, lengthscale=0.2, noise_sd=0.1, seed=0)
    lp = _gp_port(x, y, True)
    us = [init_uparams(gpt.Matern52Kernel(scaled=True), gpt.ZeroMean(),
                       [[0.0, 1.0]], 120,
                       generator=torch.Generator().manual_seed(i),
                       dtype=torch.float64, optimize_noise=True)
          for i in range(2)]
    _, unravel = ravel_tree(us[0])
    q0s = unravel(torch.stack([ravel_tree(u)[0] for u in us]))
    res = gpt.nuts_chains(lp, q0s, torch.Generator().manual_seed(1),
                          num_samples=250, num_warmup=400, max_depth=6)
    assert torch.isfinite(res.log_probs).all()
    assert float(res.diverging.double().mean()) < 0.2
    ls = torch.exp(res.samples["kernel"]["lengthscale"])
    assert 0.02 < float(ls.mean()) < 1.5
    rhat = float(gpt.potential_scale_reduction(torch.log(ls)))
    assert rhat < 1.45, rhat
