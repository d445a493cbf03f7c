"""The port's mesh paths against the JAX package's (2 of 5):
``fit_iterative`` and ``fit`` under a mesh step for step on the JAX
package's probes (restarts one after another), the mesh posteriors, and
the dp × tp restart step at 2 × 2. See ``tests/test_torch_parallel.py``
for the layout of these tests. Tolerances, relative: 1e-6 for the CG-based
fit histories and posteriors, 1e-8 for the restart step. As there, the
inputs are made once and each JAX reference is computed once, on 2
devices, for both world sizes of the port.
"""
import functools

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

import gaussianprocessfundamentals_tpu as gpf
from gaussianprocessfundamentals_tpu.config import GPConfig as JGPConfig
from gaussianprocessfundamentals_tpu.fit.fit import init_uparams as jinit
from gaussianprocessfundamentals_tpu.fit.transforms import constrain as jconstrain
from gaussianprocessfundamentals_tpu.linalg import cholesky as jchol
from gaussianprocessfundamentals_tpu.models import iterative as jit_
from gaussianprocessfundamentals_tpu.parallel import sharded as jsh
from gaussianprocessfundamentals_tpu.parallel.meshes import make_mesh as jmake_mesh

from torch_parallel_jax import (
    N_DIV,
    NOISE,
    S,
    close,
    close_tree,
    data,
    jax_probes,
    jmesh,
    kernels,
    spawn,
    spec,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 virtual devices")

FIT_KW = dict(num_probes=S, max_iters=30, tol=1e-8, precond_m=0,
              early_exit=False)
REF_P = 2  # the JAX references' mesh


@functools.lru_cache(maxsize=None)
def _cases():
    x, y = data()
    xd, yd = data(N_DIV)
    jk, jp = kernels()["se"]
    fkey = jr.PRNGKey(3)
    cases = {}
    cases["fit_iterative"] = {
        "kernel": spec(jk, jp), "x": xd, "y": yd,
        "probes": [jax_probes(jr.fold_in(fkey, i), N_DIV, S, 0)[0]
                   for i in range(3)],
        "kw": dict(FIT_KW, steps=3, lr=0.1, resid_guard=0.5,
                   init_noise=NOISE)}
    rkey = jr.fold_in(jr.PRNGKey(11), 0)
    cases["fit_routed"] = {
        "x": xd, "y": yd, "ikw": FIT_KW,
        "probes": [jax_probes(jr.fold_in(rkey, i), N_DIV, S, 0)[0]
                   for i in range(3)]}
    cases["posterior"] = {"kernel": spec(jk, jp), "x": x, "y": y,
                          "xt": np.linspace(0.05, 0.95, 13)[:, None],
                          "noise": NOISE}
    return cases


@functools.lru_cache(maxsize=None)
def _restart_inputs():
    x, y = data(40, seed=2)
    jk, jp = kernels()["composite"]
    inits = [jinit(jk, gpf.ZeroMean(), [[0.0, 1.0]], 40, key=jr.PRNGKey(i),
                   dtype=jnp.float64, optimize_noise=True) for i in range(4)]
    for u in inits:
        u.pop("mean")
    u0 = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *inits)
    return {"kernel": spec(jk, jp), "x": x, "y": y,
            "u0": jax.tree_util.tree_map(np.asarray, u0)}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """world size → every rank's results of every case."""
    return spawn(tmp_path_factory, {
        2: _cases(), 4: dict(_cases(), restart_step=_restart_inputs())})


@functools.lru_cache(maxsize=None)
def _jax_fit_iterative():
    jk, _ = kernels()["se"]
    x, y = data(N_DIV)
    mesh = jmesh(REF_P)
    c = _cases()["fit_iterative"]
    with mesh:
        return jit_.fit_iterative(
            jk, jnp.asarray(x), jnp.asarray(y), jr.PRNGKey(3),
            callback=lambda i, v: None, block=16, mesh=mesh, mesh_axis="tp",
            return_diagnostics=True, **c["kw"])


@pytest.mark.parametrize("P", [2, 4])
def test_mesh_fit_iterative_matches_jax_step_for_step(port, P):
    kp, noise, hist, diag = _jax_fit_iterative()
    for r in port[P]:
        got = r["fit_iterative"]
        close(got["hist"], hist, 1e-6, "history")
        close(got["noise"], noise, 1e-6, "noise")
        close_tree(got["kp"], kp, 1e-6, "params")
        assert got["frozen"] == pytest.approx(diag)


@functools.lru_cache(maxsize=None)
def _jax_fit_routed():
    x, y = data(N_DIV)
    mesh = jmesh(REF_P)
    ikw = dict(FIT_KW, mesh=mesh, mesh_axis="tp", block=16,
               callback=lambda i, v: None)
    with mesh:
        return gpf.fit(gpf.SquaredExponentialKernel(scaled=True),
                       jnp.asarray(x), jnp.asarray(y), key=jr.PRNGKey(11),
                       method="auto", optimize_noise=True, noise=NOISE,
                       steps=3, lr=0.1, config=JGPConfig(dense_hbm_budget=1.0),
                       iterative_kwargs=ikw)


@pytest.mark.parametrize("P", [2, 4])
def test_mesh_fit_routes_and_runs_restarts_one_after_another(port, P):
    """``fit(method="auto", iterative_kwargs={"mesh": …})`` against the JAX
    package's on its probes; with restarts=1 the mesh fit equals the same
    fit without a mesh (restarts run one after another there too)."""
    res = _jax_fit_routed()
    for r in port[P]:
        got = r["fit_routed"]
        close(got["hist"], res.history, 1e-6, "history")
        close(got["noise"], res.noise, 1e-6, "noise")
        close_tree(got["kp"], res.kernel_params, 1e-6, "params")
        close_tree(got["restarts_mesh"], got["restarts_single"], 1e-8,
                    "restarts")


@functools.lru_cache(maxsize=None)
def _jax_posteriors():
    jk, jp = kernels()["se"]
    c = _cases()["posterior"]
    x, y, xt = (jnp.asarray(c[k]) for k in ("x", "y", "xt"))
    mesh = jmesh(REF_P)
    with mesh:
        mu, var = jit_.iterative_posterior_chunked(
            jk, jp, x, y, xt, jnp.asarray(NOISE), block=16, precond_m=8,
            chunk=8, mesh=mesh, mesh_axis="tp")
    mu_m = jit_.iterative_posterior_mean(jk, jp, x, y, xt, NOISE, block=16,
                                         precond_m=8)
    mu2, var2 = jit_.iterative_posterior(jk, jp, x, y, xt, NOISE, block=16,
                                         precond_m=8)
    return mu, var, mu_m, mu2, var2


@pytest.mark.parametrize("P", [2, 4])
def test_mesh_posteriors_match_jax(port, P):
    mu, var, mu_m, mu2, var2 = _jax_posteriors()
    for r in port[P]:
        got = r["posterior"]
        close_tree(got["chunked"], (mu, var), 1e-6, "chunked")
        close(got["mean"], mu_m, 1e-6, "mean")
        close_tree(got["full"], (mu2, var2), 1e-6, "posterior")


def test_restart_sharded_fit_step_dp2_tp2_matches_jax(port):
    import optax

    c = _restart_inputs()
    jk, _ = kernels()["composite"]
    x, y = jnp.asarray(c["x"]), jnp.asarray(c["y"])
    mesh = jmake_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    kpos = jk.positivity()

    def nll_one(u):
        K = jsh.sharded_gram(jk, jconstrain(kpos, u["kernel"]), x, mesh, "tp")
        return jchol.nll(K, y, jnp.exp(u["log_noise"]), 1e-6)

    opt = optax.adam(0.05)
    u0 = jax.tree_util.tree_map(jnp.asarray, c["u0"])
    with mesh:
        st = opt.init(u0)
        u1, st, losses = jsh.restart_sharded_fit_step(nll_one, u0, opt.update,
                                                      st, mesh)
        u2, _, losses2 = jsh.restart_sharded_fit_step(nll_one, u1, opt.update,
                                                      st, mesh)
    coords = set()
    for r in port[4]:
        got = r["restart_step"]
        coords.add((got["coords"]["dp"], got["coords"]["tp"]))
        close(got["losses"], losses, 1e-8, "losses")
        close(got["losses2"], losses2, 1e-8, "losses 2")
        close_tree(got["u1"], u1, 1e-8, "params 1")
        close_tree(got["u2"], u2, 1e-8, "params 2")
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


