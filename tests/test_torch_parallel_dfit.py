"""The port's mesh paths against the JAX package's (4 of 5):
``distributed_nll_value_and_grad`` (with and without probes) and 3 steps
of ``fit_distributed`` on the JAX package's Rademacher probes, at 2 and 4
ranks. See ``tests/test_torch_parallel.py`` for the layout. n = 96 rows in
blocks of 8. Tolerances, relative: 1e-8, and 1e-6 for the fit. As there,
the inputs are made once and the JAX reference is computed once, on 2
devices, for both world sizes of the port.
"""
import functools

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

import gaussianprocessfundamentals_tpu as gpf
from gaussianprocessfundamentals_tpu.parallel import distributed_fit as jdf
from torch_parallel_jax import close, close_tree, data, jmesh, kernels, spawn, spec

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 virtual devices")

N_BC = 96
BLOCK = 8
NOISE = 0.05
REF_P = 2  # the JAX reference's mesh


@functools.lru_cache(maxsize=None)
def _fit_inputs():
    x, y = data(N_BC, seed=5)
    jk, jp = kernels()["se"]
    key = jr.PRNGKey(9)
    return {"kernel": spec(jk, jp), "x": x, "y": y, "noise": NOISE,
            "block": BLOCK,
            "z": np.asarray(jr.rademacher(key, (4, N_BC)).astype(jnp.float64)),
            "fit_probes": np.stack([
                np.asarray(jr.rademacher(jr.fold_in(key, i), (4, N_BC))
                           .astype(jnp.float64)) for i in range(3)])}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return spawn(tmp_path_factory, {P: {"distributed_fit": _fit_inputs()}
                                    for P in (2, 4)})


@functools.lru_cache(maxsize=None)
def _jax_reference():
    c = _fit_inputs()
    jk, jp = kernels()["se"]
    mesh = jmesh(REF_P)
    x, y = jnp.asarray(c["x"]), jnp.asarray(c["y"])
    key = jr.PRNGKey(9)
    with mesh:
        nll, (g, g_noise) = jdf.distributed_nll_value_and_grad(
            jk, jp, x, y, NOISE, 1e-6, mesh, key, "tp", BLOCK, 4)
        nll0, (g0, g0_noise) = jdf.distributed_nll_value_and_grad(
            jk, jp, x, y, NOISE, 1e-6, mesh, key, "tp", BLOCK, 0)
    kp, noise, hist = jdf.fit_distributed(
        gpf.SquaredExponentialKernel(), x, y, mesh, key, block=BLOCK,
        probes=4, steps=3, lr=0.1)
    return nll, g, g_noise, nll0, g0, g0_noise, kp, noise, hist


@pytest.mark.parametrize("P", [2, 4])
def test_distributed_nll_value_and_grad_and_fit_match_jax(port, P):
    nll, g, g_noise, nll0, g0, g0_noise, kp, noise, hist = _jax_reference()
    for r in port[P]:
        got = r["distributed_fit"]
        close(got["nll"], nll, 1e-8, "nll")
        close_tree(got["grad"], g, 1e-8, "gradient")
        close(got["grad_noise"], g_noise, 1e-8, "noise gradient")
        close(got["nll0"], nll0, 1e-8, "nll (no probes)")
        close_tree(got["grad0"], g0, 1e-8, "gradient (no probes)")
        close(got["grad0_noise"], g0_noise, 1e-8, "noise gradient (no probes)")
        kp_p, noise_p, hist_p = got["fit"]
        close(hist_p, hist, 1e-6, "history")
        close(noise_p, noise, 1e-6, "noise")
        close_tree(kp_p, kp, 1e-6, "params")
