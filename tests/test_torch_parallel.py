"""The port's mesh paths against the JAX package's (1 of 5): the
mesh-sharded matvec and gradient, the iterative NLL core under a mesh, the
sharded Gram algebra with ``sharded_nll``'s gradient (the routers and the
launcher are in ``tests/test_torch_parallel_launch.py``).

The JAX side runs on sub-meshes of 2 and 4 of the fake 8-device CPU mesh
(``tests/conftest.py``); the port side in spawned gloo ranks, one spawn per
world size computing every case (``tests/torch_parallel_ranks.py``, which
imports no JAX and asserts so on every rank), each case then its own test
(``tests/torch_parallel_jax.py`` holds the shared JAX side). n = 101 rows
split over neither 2 nor 4 ranks where the JAX package pads them (the
matvec and gradient); its mesh NLL core and sharded Gram need n divisible
by the mesh (``with_sharding_constraint``), so those cases run at n = 100
against it, and the port's core also at n = 101 against itself without a
mesh. Tolerances, relative: 1e-8 for products, Grams, solves and NLLs;
1e-6 for the CG-based mesh NLL and its gradient.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

from gaussianprocessfundamentals_tpu.models import iterative as jit_
from gaussianprocessfundamentals_tpu.parallel import mesh_matvec as jmm
from gaussianprocessfundamentals_tpu.parallel import sharded as jsh
from torch_parallel_jax import (
    N,
    N_DIV,
    NOISE,
    S,
    close,
    close_tree,
    data,
    jax_probes,
    jmesh,
    kernels,
    port_w,
    spawn,
    spec,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 virtual devices")

CORE_KW = dict(max_iters=5, tol=1e-14, precond_m=4, early_exit=False)


def _cases():
    x, y = data()
    xd, yd = data(N_DIV)
    rng = np.random.default_rng(1)
    V = rng.standard_normal((N, 3))
    U, W = rng.standard_normal((N, 5)), rng.standard_normal((N, 5))
    ks = kernels()
    cases = {}
    for name, (jk, jp) in ks.items():
        cases[f"matvec:{name}"] = {"kernel": spec(jk, jp), "x": x, "V": V,
                                   "U": U, "W": W}
    jk, jp = ks["se"]
    key = jr.PRNGKey(7)
    u, w = jax_probes(key, N_DIV, S, CORE_KW["precond_m"])
    w = port_w(jk, jp, xd, CORE_KW["precond_m"], w)
    u1, w1 = jax_probes(key, N, S, CORE_KW["precond_m"])
    for mat in (False, True):
        cases[f"core:{mat}"] = {"kernel": spec(jk, jp), "x": xd, "y": yd,
                                "noise": NOISE, "u": u, "w": w,
                                "kw": dict(CORE_KW, materialize=mat),
                                "x1": x, "y1": y, "u1": u1, "w1": w1}
    cases["sharded"] = {"kernel": spec(jk, jp), "x": xd, "y": yd,
                        "noise": 0.1, "jitter": 1e-8}
    return cases


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """world size → every rank's results of every case."""
    return spawn(tmp_path_factory, {P: _cases() for P in (2, 4)})


@pytest.mark.parametrize("P", [2, 4])
def test_ranks_ran_jax_free_on_gloo(port, P):
    for r in port[P]:
        assert r["backend"] == "gloo" and r["world"] == P


@pytest.mark.parametrize("name", ["se", "composite"])
@pytest.mark.parametrize("P", [2, 4])
def test_mesh_gram_matvec_and_vjp_match_jax(port, P, name):
    c = _cases()[f"matvec:{name}"]
    jk, jp = kernels()[name]
    mesh = jmesh(P)
    x = jnp.asarray(c["x"])
    with mesh:
        mv = jmm.mesh_gram_matvec(jk, jp, x, jnp.asarray(c["V"]), mesh, "tp", 16)
        g = jmm.mesh_lowrank_vjp(jk, jp, x, jnp.asarray(c["U"]),
                                 jnp.asarray(c["W"]), mesh, "tp", 16)
    for r in port[P]:  # every rank holds the replicated result
        got = r[f"matvec:{name}"]
        close(got["mv"], mv, 1e-8, "matvec")
        close(got["mv_vec"], np.asarray(mv)[:, 0], 1e-8, "matvec [n]")
        close_tree(got["vjp"], g, 1e-8, "vjp")


@pytest.mark.parametrize("materialize", [False, True])
@pytest.mark.parametrize("P", [2, 4])
def test_mesh_core_impl_matches_jax(port, P, materialize):
    """The mesh NLL core, streamed and with resident row panels, on the JAX
    package's probes: NLL pieces, gradients and residuals within 1e-6."""
    jk, jp = kernels()["se"]
    x, y = data(N_DIV)
    mesh = jmesh(P)
    with mesh:
        ref = jit_._core_impl(jk, jp, jnp.asarray(x), jnp.asarray(y), NOISE,
                              jr.PRNGKey(7), num_probes=S, block=16,
                              mesh=mesh, mesh_axis="tp",
                              materialize=materialize, **CORE_KW)
    got = port[P][0][f"core:{materialize}"]
    names = ("data_fit", "log_P", "alphas", "betas", "z_weights")
    for name, r in zip(names, ref[:5]):
        close(got[name], r, 1e-6, name)
    close_tree(got["grad_params"], ref[5], 1e-6, "grad_params")
    close(got["grad_noise"], ref[6], 1e-6, "grad_noise")
    close(got["resid"], ref[8], 1e-6, "resid")
    for r in port[P][1:]:
        close(r[f"core:{materialize}"]["grad_noise"], got["grad_noise"],
               1e-12, "replicated")
    # n = 101 (padded panels): the mesh core equals the core without one
    for a, b in zip(got["padded"], got["padded_single"]):
        close_tree(a, b, 1e-8, "n = 101")


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_gram_nll_gradient_and_cg_match_jax(port, P):
    """``sharded_nll``'s gradient flows through the gathered panels and is
    summed over the ranks once: it equals the JAX package's (a P-fold
    count would fail by a factor P)."""
    jk, jp = kernels()["se"]
    c = _cases()["sharded"]
    x, y = jnp.asarray(c["x"]), jnp.asarray(c["y"])
    mesh = jmesh(P)
    with mesh:
        K = np.asarray(jsh.sharded_gram(jk, jp, x, mesh))
        nll, grad = jax.value_and_grad(
            lambda p: jsh.sharded_nll(jk, p, x, y, 0.1, 1e-8, mesh))(jp)
        cg = jsh.sharded_cg_solve(jk, jp, x, y, 0.5, 1e-8, mesh, tol=1e-10)
    rows = N_DIV // P
    for i, r in enumerate(port[P]):
        got = r["sharded"]
        close(got["panel"], K[i * rows:(i + 1) * rows], 1e-8, "panel")
        close(got["mv"], K @ c["y"], 1e-8, "matvec")
        close(got["nll"], nll, 1e-8, "nll")
        close_tree(got["grad"], grad, 1e-8, "gradient")
        close(got["cg"], cg, 1e-8, "cg")
