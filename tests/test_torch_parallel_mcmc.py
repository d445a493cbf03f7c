"""The port's mesh paths against the JAX package's (5 of 5): HMC and NUTS
with one chain per rank and the warmup acceptance averaged over the ranks
(``hmc_chains_collective``, ``nuts_chains_collective``), on the JAX
package's replayed keys, at 2 and 4 ranks. See
``tests/test_torch_parallel.py`` for the layout. Tolerance 1e-8 relative;
the step sizes bitwise equal on every rank.
"""
from functools import partial

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

from gaussianprocessfundamentals_tpu.mcmc.hmc import hmc_chains_collective
from gaussianprocessfundamentals_tpu.mcmc.nuts import nuts_chains_collective
from torch_parallel_jax import close_tree, jmesh, spawn

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 virtual devices")

W_MC, S_MC, DEPTH = 20, 20, 4  # warmup, draws, NUTS max depth
SCALES = np.array([0.5, 2.0])  # the target of torch_parallel_ranks


def _jlogprob(q):
    return -0.5 * jnp.sum((q["x"] / jnp.asarray(SCALES)) ** 2)


def _hmc_draws(key):
    """One ``hmc()`` chain's momenta [T, 2] and accept uniforms [T] from the
    JAX package's keys (``tests/test_torch_mcmc._hmc_replay``)."""
    keys = jnp.concatenate([jr.split(jr.fold_in(key, 0), W_MC),
                            jr.split(jr.fold_in(key, 1), S_MC)])

    def one(k):
        key_mom, key_acc = jr.split(k)
        (km,) = jr.split(key_mom, 1)
        return jr.normal(km, (2,), jnp.float64), jr.uniform(key_acc, ())

    return tuple(np.asarray(a) for a in jax.vmap(one)(keys))


@partial(jax.jit, static_argnums=(1,))
def _nuts_draw(key, dim):
    """One transition's draws as ``_nuts_kernel`` makes them
    (``tests/test_torch_nuts._draws``)."""
    key_mom, _, k = jr.split(key, 3)
    mom = jr.normal(key_mom, (dim,), jnp.float64)
    dirs, merges, leaves = [], [], []
    for j in range(DEPTH):
        k, kd, kt, km = jr.split(k, 4)
        dirs.append(jr.uniform(kd, ()))
        merges.append(jr.uniform(km, (), jnp.float64))
        for _ in range(1 << j):
            kt, sk = jr.split(kt)
            leaves.append(jr.uniform(sk, (), jnp.float64))
    return mom, jnp.stack(dirs), jnp.stack(merges), jnp.stack(leaves)


def _nuts_draws(key):
    n1 = max(W_MC // 2, 1)
    keys = jnp.concatenate([jr.split(jr.fold_in(key, 0), n1),
                            jr.split(jr.fold_in(key, 2), W_MC - n1),
                            jr.split(jr.fold_in(key, 1), S_MC)])
    return tuple(np.asarray(a) for a in
                 jax.vmap(_nuts_draw, in_axes=(0, None))(keys, 2))


def _q0s(P):
    return np.random.default_rng(4).standard_normal((P, 2)) * 0.5


def _mcmc_inputs(P):
    keys = jr.split(jr.PRNGKey(5), P)
    return {"q0s": _q0s(P), "W": W_MC, "S": S_MC, "depth": DEPTH,
            "hmc_draws": [_hmc_draws(k) for k in keys],
            "nuts_draws": [_nuts_draws(k) for k in keys]}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return spawn(tmp_path_factory, {P: {"mcmc": _mcmc_inputs(P)}
                                    for P in (2, 4)})


@pytest.mark.parametrize("P", [2, 4])
def test_collective_hmc_and_nuts_match_jax(port, P):
    """One chain per rank, the warmup acceptance averaged over the ranks:
    every output equals the JAX package's on its own keys, and every rank
    ends with the bitwise-same step size."""
    keys = jr.split(jr.PRNGKey(5), P)
    mesh = jmesh(P, "dp")
    q0s = {"x": jnp.asarray(_q0s(P))}
    h = hmc_chains_collective(_jlogprob, q0s, keys, mesh, axis="dp",
                              num_samples=S_MC, num_warmup=W_MC,
                              num_leapfrog=4)
    nu = nuts_chains_collective(_jlogprob, q0s, keys, mesh, axis="dp",
                                num_samples=S_MC, num_warmup=W_MC,
                                max_depth=DEPTH)
    steps = []
    for r in port[P]:
        got = r["mcmc"]
        close_tree(got["hmc"], tuple(h), 1e-8, "hmc")
        close_tree(got["nuts"], tuple(nu), 1e-8, "nuts")
        steps += [got["hmc"][2], got["nuts"][2]]
    for k in (0, 1):  # HMC's, then NUTS's: one value on every rank and chain
        vals = np.concatenate([s.reshape(-1) for s in steps[k::2]])
        assert np.all(vals == vals[0]), vals
