"""The rank side of the multi-GPU parity tests: JAX-free, so spawned ranks
can import it (``tests/test_torch_parallel*.py`` import JAX; this module
must not).

``run_cases(cases)`` runs on every rank of a ``parallel.meshes.launch``:
each case builds its meshes, runs the port's mesh functions on numpy
inputs made by the test in the parent, and returns numpy results keyed by
case name. Every rank runs every case in the same order, as their
collectives require.
"""
from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu_torch.fit.transforms import constrain
from gaussianprocessfundamentals_tpu_torch.models import iterative
from gaussianprocessfundamentals_tpu_torch.parallel import (
    block_cholesky as bc,
)
from gaussianprocessfundamentals_tpu_torch.parallel import (
    distributed_fit,
    mesh_matvec,
    meshes,
    sharded,
)
from gaussianprocessfundamentals_tpu_torch.utils.checkpoint import (
    params_from_numpy,
)
from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
)


_DRAW_PROBES = iterative.draw_probes


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if torch.is_tensor(t) else t, tree)


def kernel_of(spec: dict):
    """A port kernel from ``{"dict": to_dict(), "params": numpy tree}``."""
    k = gpt.kernel_from_dict(spec["dict"])
    return params_from_numpy(k, spec["params"], dtype=torch.float64)


def gauss_logprob(q):
    """The MCMC cases' target: a Gaussian with scales 0.5 and 2."""
    s = torch.tensor([0.5, 2.0], dtype=q["x"].dtype)
    return -0.5 * torch.sum((q["x"] / s) ** 2)


def hmc_source(mom, u):
    return lambda t: (_t(mom[t])[None], _t(u[t:t + 1]))


def nuts_source(mom, dirs, merges, leaves):
    from gaussianprocessfundamentals_tpu_torch.mcmc.nuts import NUTSDraws

    return lambda t: NUTSDraws(_t(mom[t])[None], _t(dirs[t])[:, None],
                               _t(merges[t])[:, None], _t(leaves[t])[:, None])


# --- the cases -------------------------------------------------------------

def case_matvec(c):
    mesh = meshes.single_axis_mesh("tp")
    k = kernel_of(c["kernel"])
    x, V = _t(c["x"]), _t(c["V"])
    return {"mv": mesh_matvec.mesh_gram_matvec(k, x, V, mesh, block=16),
            "mv_vec": mesh_matvec.mesh_gram_matvec(k, x, V[:, 0], mesh),
            "vjp": mesh_matvec.mesh_lowrank_vjp(k, x, _t(c["U"]), _t(c["W"]),
                                                mesh, block=16)}


def case_core(c):
    mesh = meshes.single_axis_mesh("tp")
    k = kernel_of(c["kernel"])
    out = iterative._core_impl(k, _t(c["x"]), _t(c["y"]), c["noise"],
                               _t(c["u"]), _t(c["w"]), mesh=mesh, **c["kw"])
    out = dict(zip(("data_fit", "log_P", "alphas", "betas", "z_weights",
                    "grad_params", "grad_noise", "grad_mean", "resid"), out))
    args = (k, _t(c["x1"]), _t(c["y1"]), c["noise"], _t(c["u1"]),
            _t(c["w1"]))
    out["padded"] = iterative._core_impl(*args, mesh=mesh, **c["kw"])
    out["padded_single"] = iterative._core_impl(*args, **c["kw"])
    return out


def case_fit_iterative(c):
    mesh = meshes.single_axis_mesh("tp")
    draws = iter(c["probes"])
    iterative.draw_probes = lambda *a: (_t(next(draws)), None)
    k = kernel_of(c["kernel"])
    kp, noise, hist, diag = iterative.fit_iterative(
        k, _t(c["x"]), _t(c["y"]), mesh=mesh, return_diagnostics=True,
        **c["kw"])
    return {"kp": kp, "noise": noise, "hist": hist, "frozen": diag}


def case_fit_routed(c):
    """fit(method="auto") with the mesh in iterative_kwargs: restarts=0 on
    the JAX package's probes, and restarts=1 against the same fit without
    a mesh on this rank."""
    mesh = meshes.single_axis_mesh("tp")
    x, y = _t(c["x"]), _t(c["y"])
    draws = iter(c["probes"])
    iterative.draw_probes = lambda *a: (_t(next(draws)), None)
    kw = dict(method="auto", optimize_noise=True, noise=0.05, steps=3,
              lr=0.1, config=gpt.GPConfig(dense_hbm_budget=1.0))
    res = gpt.fit(gpt.SquaredExponentialKernel(scaled=True), x, y,
                  iterative_kwargs=dict(c["ikw"], mesh=mesh), **kw)
    gen = torch.Generator().manual_seed(5)
    iterative.draw_probes = _DRAW_PROBES
    runs = []
    for m in (mesh, None):
        gen.manual_seed(5)
        r = gpt.fit(gpt.SquaredExponentialKernel(scaled=True), x, y,
                    restarts=1, generator=gen,
                    iterative_kwargs=dict(c["ikw"], mesh=m), **kw)
        runs.append((r.history, r.kernel_params, r.noise))
    return {"hist": res.history, "kp": res.kernel_params, "noise": res.noise,
            "restarts_mesh": runs[0], "restarts_single": runs[1]}


def case_posterior(c):
    mesh = meshes.single_axis_mesh("tp")
    k = kernel_of(c["kernel"])
    x, y, xt = _t(c["x"]), _t(c["y"]), _t(c["xt"])
    noise = c["noise"]
    stats = {}
    mu, var = iterative.iterative_posterior_chunked(
        k, x, y, xt, noise, precond_m=8, chunk=8, stats=stats, mesh=mesh)
    mu_m = iterative.iterative_posterior_mean(k, x, y, xt, noise, precond_m=8,
                                              mesh=mesh)
    mu2, var2 = iterative.iterative_posterior(k, x, y, xt, noise,
                                              precond_m=8, mesh=mesh)
    return {"chunked": (mu, var), "mean": mu_m, "full": (mu2, var2),
            "iters": stats["iters"]}


def case_sharded(c):
    mesh = meshes.single_axis_mesh("tp")
    k = kernel_of(c["kernel"])
    x, y = _t(c["x"]), _t(c["y"])
    panel = sharded.sharded_gram(k, x, mesh)
    mv = sharded.sharded_matvec(panel, y, mesh)
    with k.differentiable() as kp:
        nll = sharded.sharded_nll(k, x, y, c["noise"], c["jitter"], mesh)
        leaves = tree_leaves(kp)
        grads = torch.autograd.grad(nll, leaves)
    cg = sharded.sharded_cg_solve(k, x, y, 0.5, c["jitter"], mesh, tol=1e-10)
    return {"panel": panel, "mv": mv, "nll": nll.detach(),
            "grad": dict(zip(sorted(kp), grads)), "cg": cg}


def case_restart_step(c):
    """The dp × tp restart step (2 × 2): restarts on dp, Gram rows on tp."""
    mesh = meshes.make_mesh(dp=2, tp=2)
    k = kernel_of(c["kernel"])
    x, y = _t(c["x"]), _t(c["y"])
    pos = k.positivity()

    def nll_fn(u):
        k.set_params(constrain(pos, u["kernel"]))
        return sharded.sharded_nll(k, x, y, torch.exp(u["log_noise"]), 1e-6,
                                   mesh, "tp")

    u0 = tree_map(_t, c["u0"])
    opt = sharded.adam(0.05)
    u1, st, losses = sharded.restart_sharded_fit_step(
        nll_fn, u0, opt.update, opt.init(u0), mesh)
    u2, _, losses2 = sharded.restart_sharded_fit_step(
        nll_fn, u1, opt.update, st, mesh)
    return {"u1": u1, "losses": losses, "u2": u2, "losses2": losses2,
            "coords": mesh.coords}


def case_block_cholesky(c):
    mesh = meshes.single_axis_mesh("tp")
    B = c["block"]
    K, y, Y = _t(c["K"]), _t(c["y"]), _t(c["Y"])
    k = kernel_of(c["kernel"])
    x, xt = _t(c["x"]), _t(c["xt"])
    n = K.shape[0]
    Kn = K + 0.1 * torch.eye(n, dtype=K.dtype)
    L, logdet = bc.distributed_cholesky(Kn, mesh, block=B)
    L2, Linv, logdet2 = bc.distributed_cholesky_factor(Kn, mesh, block=B)
    panel = bc.cyclic_gram(k, x, B, mesh, diag_add=0.1)
    return {
        "L": bc.gather_cyclic(L, mesh), "logdet": logdet,
        "logdet2": logdet2, "Linv": Linv,
        "panel": bc.gather_cyclic(panel, mesh),
        "solve": bc.distributed_chol_solve(L, y, mesh, block=B),
        "solve_inv": bc.distributed_chol_solve_inv(L2, Linv, Y, mesh, block=B),
        "nll": bc.distributed_nll(K, y, 0.1, 1e-6, mesh, block=B),
        "nll_unroll": bc.distributed_nll(K, y, 0.1, 1e-6, mesh, block=B,
                                         unroll=True),
        "nll_rows": bc.distributed_nll(bc.cyclic_gram(k, x, B, mesh), y, 0.1,
                                       1e-6, mesh, block=B),
        "posterior": bc.distributed_posterior(k, x, y, xt, 0.1, 1e-6, mesh,
                                              block=B),
    }


def case_distributed_fit(c):
    mesh = meshes.single_axis_mesh("tp")
    k = kernel_of(c["kernel"])
    x, y = _t(c["x"]), _t(c["y"])
    nll, (g, g_noise) = distributed_fit.distributed_nll_value_and_grad(
        k, x, y, c["noise"], 1e-6, mesh, _t(c["z"]), block=c["block"])
    nll0, (g0, g0_noise) = distributed_fit.distributed_nll_value_and_grad(
        k, x, y, c["noise"], 1e-6, mesh, 0, block=c["block"])
    probes = c["fit_probes"]
    kf = gpt.SquaredExponentialKernel()
    kp, noise, hist = distributed_fit.fit_distributed(
        kf, x, y, mesh, block=c["block"], probes=probes.shape[1],
        steps=probes.shape[0], lr=0.1, probe_draws=lambda i: _t(probes[i]))
    return {"nll": nll, "grad": g, "grad_noise": g_noise, "nll0": nll0,
            "grad0": g0, "grad0_noise": g0_noise, "fit": (kp, noise, hist)}


def case_mcmc(c):
    mesh = meshes.single_axis_mesh("dp")
    i = mesh.index("dp")
    q0s = {"x": _t(c["q0s"])}
    h = gpt.hmc_chains_collective(
        gauss_logprob, q0s, hmc_source(*c["hmc_draws"][i]), mesh,
        num_samples=c["S"], num_warmup=c["W"], num_leapfrog=4)
    nu = gpt.nuts_chains_collective(
        gauss_logprob, q0s, nuts_source(*c["nuts_draws"][i]), mesh,
        num_samples=c["S"], num_warmup=c["W"], max_depth=c["depth"])
    return {"hmc": tuple(h), "nuts": tuple(nu)[:7]}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def raise_on_rank_one():
    if dist.get_rank() == 1:
        raise RuntimeError("rank one fails")
    return dist.get_rank()


def hang_on_rank_one():
    import time

    if dist.get_rank() == 1:
        time.sleep(60)
    return dist.get_rank()


def run_cases(cases: dict) -> dict:
    """Every case of ``cases`` (name → inputs) on this rank, in order;
    returns name → numpy results, plus the backend and world size."""
    assert "jax" not in sys.modules, "a rank imported JAX"
    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    for name, inputs in cases.items():
        out[name] = _np(CASES[name.split(":")[0]](inputs))
        iterative.draw_probes = _DRAW_PROBES
    return out


def card_cases() -> dict:
    """The card tests' rank work (``tests/test_torch_cuda.py``): the mesh
    Gram·V through K1 with its launches, and the gathered cyclic K5
    block-rows with σ² + jitter on the global diagonal, on float32 CUDA
    data from a fixed seed."""
    from gaussianprocessfundamentals_tpu_torch.ops import (
        cuda_dense_gram,
        cuda_gram,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = meshes.single_axis_mesh("tp")
    x, V, k = card_inputs()
    cuda_gram.fused_gram_matvec_cross.launches = 0
    mv = mesh_matvec.mesh_gram_matvec(k, x, V, mesh)
    k1 = cuda_gram.fused_gram_matvec_cross.launches
    cuda_dense_gram.se_gram.launches = 0
    panel = bc.cyclic_gram(k, x[:CARD_N_BC], CARD_BLOCK, mesh,
                           diag_add=CARD_DIAG)
    k5 = cuda_dense_gram.se_gram.launches
    return {"mv": mv, "k1": k1, "panel": bc.gather_cyclic(panel, mesh),
            "k5": k5, "backend": dist.get_backend(),
            "jax_free": "jax" not in sys.modules}


CARD_N, CARD_N_BC, CARD_BLOCK, CARD_DIAG = 5001, 2048, 256, 0.0125


def card_inputs():
    g = torch.Generator().manual_seed(11)
    x = torch.rand(CARD_N, 1, generator=g).cuda()
    V = torch.randn(CARD_N, 9, generator=g).cuda()
    k = gpt.SquaredExponentialKernel(scaled=True)
    k.set_params({"lengthscale": torch.tensor(0.1),
                  "variance": torch.tensor(1.3)})
    return x, V, k.cuda()
