"""The port's mesh paths against the JAX package's: the mesh-sharded
matvec and gradient, the iterative NLL core under a mesh, the sharded Gram
algebra with ``sharded_nll``'s gradient; ``fit_iterative`` and ``fit``
under a mesh step for step on the JAX package's probes (restarts one after
another), the mesh posteriors and the dp × tp restart step at 2 × 2; the
block-cyclic distributed Cholesky (the factor through
``from_cyclic_blocks``, the diagonal blocks' inverses, both solves, the NLL
from K and from each rank's own block-rows, the exact posterior) and the
dry run over 4 ranks; ``distributed_nll_value_and_grad`` (with and without
probes) and 3 steps of ``fit_distributed`` on the JAX package's Rademacher
probes; HMC and NUTS with one chain per rank and the warmup acceptance
averaged over the ranks, on the JAX package's replayed keys. The routers
and the launcher are in ``tests/test_torch_parallel_launch.py``.

The JAX side runs on sub-meshes of the fake 8-device CPU mesh
(``tests/conftest.py``); the port side in spawned gloo ranks, ONE spawn per
world size (2 and 4) computing every case of this module
(``tests/torch_parallel_ranks.py``, which imports no JAX and asserts so on
every rank), each case then its own test (``tests/torch_parallel_jax.py``
holds the shared JAX side).

Sizes: n = 101 rows split over neither 2 nor 4 ranks where the JAX package
pads them (the matvec and gradient, the posteriors); its mesh NLL core,
fit and sharded Gram need n divisible by the mesh
(``with_sharding_constraint``), so those cases run at n = 100 against it,
and the port's core also at n = 101 against itself without a mesh. The
block-cyclic cases run at n = 96 rows in blocks of 8 (the JAX package
needs n a multiple of block·P).

Tolerances, relative: 1e-8 for products, Grams, solves, NLLs, the
block-cyclic algebra, the restart step and the MCMC chains (the step sizes
bitwise equal on every rank); 1e-6 for the CG-based mesh NLL, its
gradient, the fit histories and the mesh posteriors.

The inputs are made once per module, and each JAX reference but the MCMC
chains' (one chain per device) is computed once, jitted (run eagerly, the
mesh code compiles each of its operations on its own), on a sub-mesh of 2
devices: the JAX package's mesh code computes the same numbers on 2 and 4
devices, up to round-off far inside these tolerances, so the port's 2 and
4 ranks are both held to the one reference (the block-cyclic factor is
compared dense, the block-rows in each world size's own layout).
"""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
from gaussianprocessfundamentals_tpu.config import GPConfig as JGPConfig
from gaussianprocessfundamentals_tpu.fit.fit import init_uparams as jinit
from gaussianprocessfundamentals_tpu.fit.transforms import constrain as jconstrain
from gaussianprocessfundamentals_tpu.linalg import cholesky as jchol
from gaussianprocessfundamentals_tpu.mcmc.hmc import hmc_chains_collective
from gaussianprocessfundamentals_tpu.mcmc.nuts import nuts_chains_collective
from gaussianprocessfundamentals_tpu.models import iterative as jit_
from gaussianprocessfundamentals_tpu.parallel import block_cholesky as jbc
from gaussianprocessfundamentals_tpu.parallel import distributed_fit as jdf
from gaussianprocessfundamentals_tpu.parallel import mesh_matvec as jmm
from gaussianprocessfundamentals_tpu.parallel import sharded as jsh
from gaussianprocessfundamentals_tpu.parallel.meshes import make_mesh as jmake_mesh
from gaussianprocessfundamentals_tpu_torch.parallel import block_cholesky as bc
from gaussianprocessfundamentals_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
)
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
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 virtual devices")

REF_P = 2  # the JAX references' mesh
CORE_KW = dict(max_iters=5, tol=1e-14, precond_m=4, early_exit=False)
FIT_KW = dict(num_probes=S, max_iters=30, tol=1e-8, precond_m=0,
              early_exit=False)
N_BC = 96  # the block-cyclic cases' rows
BLOCK = 8
W_MC, S_MC, DEPTH = 20, 20, 4  # MCMC warmup, draws, NUTS max depth
SCALES = np.array([0.5, 2.0])  # the MCMC target of torch_parallel_ranks


# --- the inputs ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mesh_cases():
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


@functools.lru_cache(maxsize=None)
def _fit_cases():
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


@functools.lru_cache(maxsize=None)
def _chol_inputs():
    x, y = data(N_BC, seed=5)
    jk, jp = kernels()["se"]
    K = np.asarray(jk.gram(jp, jnp.asarray(x), jnp.asarray(x)))
    return {"kernel": spec(jk, jp), "x": x, "y": y, "K": K,
            "Y": np.random.default_rng(6).standard_normal((N_BC, 3)),
            "xt": np.linspace(0.02, 0.98, 9)[:, None], "block": BLOCK}


@functools.lru_cache(maxsize=None)
def _dfit_inputs():
    x, y = data(N_BC, seed=5)
    jk, jp = kernels()["se"]
    key = jr.PRNGKey(9)
    return {"kernel": spec(jk, jp), "x": x, "y": y, "noise": NOISE,
            "block": BLOCK,
            "z": np.asarray(jr.rademacher(key, (4, N_BC)).astype(jnp.float64)),
            "fit_probes": np.stack([
                np.asarray(jr.rademacher(jr.fold_in(key, i), (4, N_BC))
                           .astype(jnp.float64)) for i in range(3)])}


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

    def leaf(kt, _):
        kt, sk = jr.split(kt)
        return kt, jr.uniform(sk, (), jnp.float64)

    dirs, merges, leaves = [], [], []
    for j in range(DEPTH):
        k, kd, kt, km = jr.split(k, 4)
        dirs.append(jr.uniform(kd, ()))
        merges.append(jr.uniform(km, (), jnp.float64))
        leaves.append(jax.lax.scan(leaf, kt, None, length=1 << j)[1])
    return mom, jnp.stack(dirs), jnp.stack(merges), jnp.concatenate(leaves)


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


def _cases(P):
    """Every case of this module at world size P, in the order the ranks
    run them."""
    cases = dict(_mesh_cases())
    cases.update(_fit_cases())
    if P == 4:
        cases["restart_step"] = _restart_inputs()
    cases["block_cholesky"] = _chol_inputs()
    cases["distributed_fit"] = _dfit_inputs()
    cases["mcmc"] = _mcmc_inputs(P)
    return cases


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """world size → every rank's results of every case."""
    return spawn(tmp_path_factory, {P: _cases(P) for P in (2, 4)})


@pytest.mark.parametrize("P", [2, 4])
def test_ranks_ran_jax_free_on_gloo(port, P):
    for r in port[P]:
        assert r["backend"] == "gloo" and r["world"] == P


# --- the mesh matvec, NLL core and sharded Gram algebra ----------------------

@functools.lru_cache(maxsize=None)
def _jax_matvec(name):
    c = _mesh_cases()[f"matvec:{name}"]
    jk, jp = kernels()[name]
    mesh = jmesh(REF_P)
    x = jnp.asarray(c["x"])
    with mesh:
        mv = jmm.mesh_gram_matvec(jk, jp, x, jnp.asarray(c["V"]), mesh, "tp", 16)
        g = jmm.mesh_lowrank_vjp(jk, jp, x, jnp.asarray(c["U"]),
                                 jnp.asarray(c["W"]), mesh, "tp", 16)
    return mv, g


@pytest.mark.parametrize("name", ["se", "composite"])
@pytest.mark.parametrize("P", [2, 4])
def test_mesh_gram_matvec_and_vjp_match_jax(port, P, name):
    mv, g = _jax_matvec(name)
    for r in port[P]:  # every rank holds the replicated result
        got = r[f"matvec:{name}"]
        close(got["mv"], mv, 1e-8, "matvec")
        close(got["mv_vec"], np.asarray(mv)[:, 0], 1e-8, "matvec [n]")
        close_tree(got["vjp"], g, 1e-8, "vjp")


@functools.lru_cache(maxsize=None)
def _jax_core(materialize):
    jk, jp = kernels()["se"]
    x, y = data(N_DIV)
    mesh = jmesh(REF_P)
    core = partial(jit_._core_impl, jk, num_probes=S, block=16, mesh=mesh,
                   mesh_axis="tp", materialize=materialize, **CORE_KW)
    with mesh:
        return jax.jit(core)(jp, jnp.asarray(x), jnp.asarray(y), NOISE,
                             jr.PRNGKey(7))


@pytest.mark.parametrize("materialize", [False, True])
@pytest.mark.parametrize("P", [2, 4])
def test_mesh_core_impl_matches_jax(port, P, materialize):
    """The mesh NLL core, streamed and with resident row panels, on the JAX
    package's probes: NLL pieces, gradients and residuals within 1e-6."""
    ref = _jax_core(materialize)
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


@functools.lru_cache(maxsize=None)
def _jax_sharded():
    jk, jp = kernels()["se"]
    c = _mesh_cases()["sharded"]
    mesh = jmesh(REF_P)

    @jax.jit
    def ref(jp, x, y):
        K = jsh.sharded_gram(jk, jp, x, mesh)
        nll, grad = jax.value_and_grad(
            lambda p: jsh.sharded_nll(jk, p, x, y, 0.1, 1e-8, mesh))(jp)
        cg = jsh.sharded_cg_solve(jk, jp, x, y, 0.5, 1e-8, mesh, tol=1e-10)
        return K, nll, grad, cg

    with mesh:
        K, nll, grad, cg = ref(jp, jnp.asarray(c["x"]), jnp.asarray(c["y"]))
    return np.asarray(K), nll, grad, cg


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_gram_nll_gradient_and_cg_match_jax(port, P):
    """``sharded_nll``'s gradient flows through the gathered panels and is
    summed over the ranks once: it equals the JAX package's (a P-fold
    count would fail by a factor P)."""
    c = _mesh_cases()["sharded"]
    K, nll, grad, cg = _jax_sharded()
    rows = N_DIV // P
    for i, r in enumerate(port[P]):
        got = r["sharded"]
        close(got["panel"], K[i * rows:(i + 1) * rows], 1e-8, "panel")
        close(got["mv"], K @ c["y"], 1e-8, "matvec")
        close(got["nll"], nll, 1e-8, "nll")
        close_tree(got["grad"], grad, 1e-8, "gradient")
        close(got["cg"], cg, 1e-8, "cg")


# --- fits and posteriors under a mesh ----------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fit_iterative():
    jk, _ = kernels()["se"]
    x, y = data(N_DIV)
    mesh = jmesh(REF_P)
    c = _fit_cases()["fit_iterative"]
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
    c = _fit_cases()["posterior"]
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
    step = jax.jit(lambda u, st: jsh.restart_sharded_fit_step(
        nll_one, u, opt.update, st, mesh))
    with mesh:
        st = opt.init(u0)
        u1, st, losses = step(u0, st)
        u2, _, losses2 = step(u1, st)
    coords = set()
    for r in port[4]:
        got = r["restart_step"]
        coords.add((got["coords"]["dp"], got["coords"]["tp"]))
        close(got["losses"], losses, 1e-8, "losses")
        close(got["losses2"], losses2, 1e-8, "losses 2")
        close_tree(got["u1"], u1, 1e-8, "params 1")
        close_tree(got["u2"], u2, 1e-8, "params 2")
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


# --- the block-cyclic distributed Cholesky and fit_distributed ---------------

@functools.lru_cache(maxsize=None)
def _jax_cholesky():
    c = _chol_inputs()
    mesh = jmesh(REF_P)
    K = jnp.asarray(c["K"])
    Kn = K + 0.1 * jnp.eye(N_BC)
    y, Y = jnp.asarray(c["y"]), jnp.asarray(c["Y"])
    with mesh:
        L, logdet = jbc.distributed_cholesky(Kn, mesh, "tp", BLOCK)
        L2, Linv, logdet2 = jbc.distributed_cholesky_factor(Kn, mesh, "tp",
                                                            BLOCK)
        solve = jbc.distributed_chol_solve(L, y, mesh, "tp", BLOCK)
        solve_inv = jbc.distributed_chol_solve_inv(L2, Linv, Y, mesh, "tp",
                                                   BLOCK)
    dense = np.asarray(jbc.from_cyclic_blocks(L, REF_P))
    np.testing.assert_allclose(dense, np.linalg.cholesky(np.asarray(Kn)),
                               atol=1e-10)
    return dense, logdet, logdet2, Linv, solve, solve_inv


@pytest.mark.parametrize("P", [2, 4])
def test_block_cyclic_cholesky_and_solves_match_jax(port, P):
    K = jnp.asarray(_chol_inputs()["K"])
    dense, logdet, logdet2, Linv, solve, solve_inv = _jax_cholesky()
    for r in port[P]:
        got = r["block_cholesky"]
        L_port = bc.from_cyclic_blocks(torch.from_numpy(got["L"]), P)
        close(L_port, dense, 1e-8, "factor")
        close(got["logdet"], logdet, 1e-8, "logdet")
        close(got["logdet2"], logdet2, 1e-8, "logdet (factor)")
        close(got["Linv"], Linv, 1e-8, "Linv")
        close(got["solve"], solve, 1e-8, "solve")
        close(got["solve_inv"], solve_inv, 1e-8, "solve with Linv")
        close(got["panel"],
              jbc.to_cyclic_blocks(K + 0.1 * jnp.eye(N_BC), BLOCK, P), 1e-8,
              "cyclic block-rows with the noise on the global diagonal")


@functools.lru_cache(maxsize=None)
def _jax_nll_and_posterior():
    c = _chol_inputs()
    jk, jp = kernels()["se"]
    mesh = jmesh(REF_P)
    K, y = jnp.asarray(c["K"]), jnp.asarray(c["y"])
    with mesh:
        nll = jbc.distributed_nll(K, y, 0.1, 1e-6, mesh, block=BLOCK)
        nll_u = jbc.distributed_nll(K, y, 0.1, 1e-6, mesh, block=BLOCK,
                                    unroll=True)
        post = jbc.distributed_posterior(jk, jp, jnp.asarray(c["x"]), y,
                                         jnp.asarray(c["xt"]), 0.1, 1e-6,
                                         mesh, block=BLOCK)
    return nll, nll_u, post


@pytest.mark.parametrize("P", [2, 4])
def test_distributed_nll_and_posterior_match_jax(port, P):
    nll, nll_u, post = _jax_nll_and_posterior()
    for r in port[P]:
        got = r["block_cholesky"]
        close(got["nll"], nll, 1e-8, "nll")
        close(got["nll_unroll"], nll_u, 1e-8, "nll (unroll)")
        close(got["nll_rows"], nll, 1e-8, "nll from the rank's block-rows")
        close_tree(got["posterior"], post, 1e-8, "posterior")


def test_dryrun_multichip_four_ranks(tmp_path):
    res = dryrun_multichip(4, init_method=f"file://{tmp_path}/pg")
    assert res["dp"] == 2 and res["tp"] == 2 and res["backend"] == "gloo"
    assert res["jax_free"]


@functools.lru_cache(maxsize=None)
def _jax_distributed_fit():
    c = _dfit_inputs()
    jk, jp = kernels()["se"]
    mesh = jmesh(REF_P)
    x, y = jnp.asarray(c["x"]), jnp.asarray(c["y"])
    key = jr.PRNGKey(9)
    with mesh:
        nll, (g, g_noise) = jax.jit(partial(
            jdf.distributed_nll_value_and_grad, jk, jitter=1e-6, mesh=mesh,
            axis="tp", block=BLOCK, probes=4))(jp, x, y, NOISE, key=key)
        nll0, (g0, g0_noise) = jax.jit(partial(
            jdf.distributed_nll_value_and_grad, jk, jitter=1e-6, mesh=mesh,
            axis="tp", block=BLOCK, probes=0))(jp, x, y, NOISE, key=key)
    kp, noise, hist = jdf.fit_distributed(
        gpf.SquaredExponentialKernel(), x, y, mesh, key, block=BLOCK,
        probes=4, steps=3, lr=0.1)
    return nll, g, g_noise, nll0, g0, g0_noise, kp, noise, hist


@pytest.mark.parametrize("P", [2, 4])
def test_distributed_nll_value_and_grad_and_fit_match_jax(port, P):
    nll, g, g_noise, nll0, g0, g0_noise, kp, noise, hist = (
        _jax_distributed_fit())
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


# --- HMC and NUTS with one chain per rank ------------------------------------

@pytest.mark.parametrize("P", [2, 4])
def test_collective_hmc_and_nuts_match_jax(port, P):
    """One chain per rank, the warmup acceptance averaged over the ranks:
    every output equals the JAX package's on its own keys, and every rank
    ends with the bitwise-same step size."""
    keys = jr.split(jr.PRNGKey(5), P)
    mesh = jmesh(P, "dp")
    q0s = {"x": jnp.asarray(_q0s(P))}
    # jitted: run eagerly, shard_map compiles every operation of the chains
    # on its own
    h = jax.jit(partial(hmc_chains_collective, _jlogprob, mesh=mesh,
                        axis="dp", num_samples=S_MC, num_warmup=W_MC,
                        num_leapfrog=4))(q0s, keys)
    nu = jax.jit(partial(nuts_chains_collective, _jlogprob, mesh=mesh,
                         axis="dp", num_samples=S_MC, num_warmup=W_MC,
                         max_depth=DEPTH))(q0s, keys)
    steps = []
    for r in port[P]:
        got = r["mcmc"]
        close_tree(got["hmc"], tuple(h), 1e-8, "hmc")
        close_tree(got["nuts"], tuple(nu), 1e-8, "nuts")
        steps += [got["hmc"][2], got["nuts"][2]]
    for k in (0, 1):  # HMC's, then NUTS's: one value on every rank and chain
        vals = np.concatenate([s.reshape(-1) for s in steps[k::2]])
        assert np.all(vals == vals[0]), vals
