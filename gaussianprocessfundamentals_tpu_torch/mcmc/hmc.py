"""Hamiltonian Monte Carlo over GP hyperparameters, with the chains on a
leading batch axis, and the split-R̂ / ESS diagnostics.

Counterpart of ``gaussianprocessfundamentals_tpu/mcmc/hmc.py``:
``leapfrog`` (``:54``), ``hmc`` (``:70``), ``hmc_chains`` (``:139``),
``hmc_chains_collective`` (``:162``), ``potential_scale_reduction``
(``:206``) and ``effective_sample_size`` (``:220``). The target is the unconstrained-space log posterior; warmup
adapts each chain's step size by dual averaging (Hoffman & Gelman 2014,
Algorithm 5: γ 0.05, t₀ 10, κ 0.75, μ = log(10·ε₀)) towards the target
acceptance, and sampling runs at exp(log ε̄).

The JAX package vmaps a single-chain program over the chains. Here the C
chains are one [C, dim] tensor of flattened positions (``ravel_pytree``'s
order, :func:`..utils.tree.ravel_tree`), and ``hmc_chains`` takes a
``logprob_fn`` that maps the stacked tree (every leaf [C, ...]) to [C]:
the gradient is autograd of the sum, and the chains stay independent. A
step makes no host read. The random numbers come from a draw source
indexed by transition, ``source(t) -> (normals [C, dim], uniforms [C])``
(the momentum and the accept test); a ``torch.Generator`` on the chains'
device fills one (:func:`generator_draws`), and the tests replay the JAX
package's key schedule through one.

The collective form runs one chain per rank of a mesh axis
(:mod:`..parallel.meshes`): each warmup acceptance is averaged over the
ranks by one all-reduce before dual averaging (the JAX package's
``adapt_pmean_axis``), so every chain adapts the same step size.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    ravel_tree,
    tree_map,
)

# dual averaging (Hoffman & Gelman 2014, Algorithm 5)
DA_GAMMA, DA_T0, DA_KAPPA = 0.05, 10.0, 0.75


class HMCResult(NamedTuple):
    samples: Any  # tree, leaves [num_samples, ...] ([C, S, ...] for chains)
    accept_prob: torch.Tensor  # [num_samples]
    step_size: torch.Tensor  # final adapted step size
    log_probs: torch.Tensor  # [num_samples]


def value_and_grad(logprob_fn: Callable, unravel: Callable) -> Callable:
    """``lpg(q) -> (lp [C], ∇lp [C, dim])`` for flat positions q [C, dim]:
    ``logprob_fn`` takes ``unravel(q)`` (every leaf [C, ...]) and returns
    [C]; the gradient is autograd of the sum over the chains."""

    def lpg(q):
        with torch.enable_grad():
            q = q.detach().requires_grad_(True)
            lp = logprob_fn(unravel(q))
            (g,) = torch.autograd.grad(lp.sum(), q)
        return lp.detach(), g

    return lpg


def single_chain(logprob_fn: Callable) -> Callable:
    """A stacked ``logprob_fn`` (leaves [1, ...] → [1]) from a single-chain
    one (leaves [...] → scalar)."""
    return lambda tree: logprob_fn(tree_map(lambda l: l[0], tree)).reshape(1)


def chain_axis(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``v`` [C] shaped to broadcast against ``like`` [C, ...]."""
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``a`` where the per-chain ``mask`` [C] holds, else ``b``."""
    return torch.where(chain_axis(mask, a), a, b)


def _axpy(a, x, y):  # y + a*x
    return tree_map(lambda xi, yi: yi + a * xi, x, y)


def integrate(lpg: Callable, q, p, g, step_size, num_steps: int):
    """``num_steps`` leapfrog steps from (q, p) with ∇lp(q) = g; returns
    (q, p, lp, ∇lp) at the end. ``step_size`` broadcasts against q."""
    lp = None
    for _ in range(num_steps):
        p_half = _axpy(0.5 * step_size, g, p)
        q = _axpy(step_size, p_half, q)
        lp, g = lpg(q)
        p = _axpy(0.5 * step_size, g, p_half)
    return q, p, lp, g


def leapfrog(logprob_grad: Callable, q, p, step_size, num_steps: int):
    """Standard leapfrog integrator over a tensor or tree state;
    ``logprob_grad(q) -> (lp, ∇lp)``."""
    _, g = logprob_grad(q)
    q, p, _, _ = integrate(logprob_grad, q, p, g, step_size, num_steps)
    return q, p


def generator_draws(generator: torch.Generator, like: torch.Tensor
                    ) -> Callable:
    """The production draw source: per transition, standard normals
    [C, dim] and uniforms [C] from ``generator`` (on ``like``'s device),
    in call order."""
    C, dim = like.shape

    def draw(t: int):
        return (torch.randn((C, dim), generator=generator, dtype=like.dtype,
                            device=like.device),
                torch.rand((C,), generator=generator, dtype=like.dtype,
                           device=like.device))

    return draw


def _source(generator, q: torch.Tensor) -> Callable:
    if isinstance(generator, torch.Generator):
        return generator_draws(generator, q)
    return generator


def dual_averaging_update(log_eps_bar, h_bar, accept, t: float, mu: float,
                          target_accept: float):
    """One step of Algorithm 5 at iteration t (1-based); returns
    (log ε, log ε̄, h̄)."""
    eta = 1.0 / (t + DA_T0)
    h_bar = (1.0 - eta) * h_bar + eta * (target_accept - accept)
    log_eps = mu - math.sqrt(t) / DA_GAMMA * h_bar
    w = t ** (-DA_KAPPA)
    log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
    return log_eps, log_eps_bar, h_bar


def _hmc(lpg, q, source, num_samples, num_warmup, num_leapfrog,
         init_step_size, target_accept, accept_reduce=None):
    """HMC over C chains at once from flat positions q [C, dim]; returns
    (flat samples [C, S, dim], accept [C, S], step size [C], lp [C, S]).
    ``accept_reduce`` maps each warmup acceptance before dual averaging
    (the collective form's mean over the ranks)."""
    if num_leapfrog < 1:
        raise ValueError(f"num_leapfrog must be ≥ 1, got {num_leapfrog}")
    C = q.shape[0]
    lp, g = lpg(q)

    def kernel(t, q, lp, g, step_size):
        normals, u = source(t)
        q_new, p_new, lp_new, g_new = integrate(
            lpg, q, normals, g, chain_axis(step_size, q), num_leapfrog)
        ke_old = 0.5 * torch.sum(normals * normals, dim=-1)
        ke_new = 0.5 * torch.sum(p_new * p_new, dim=-1)
        log_accept = (lp_new - ke_new) - (lp - ke_old)
        log_accept = torch.where(torch.isnan(log_accept),
                                 -torch.inf, log_accept)
        accept_prob = torch.clamp_max(torch.exp(log_accept), 1.0)
        accept = u < accept_prob
        return (select(accept, q_new, q), torch.where(accept, lp_new, lp),
                select(accept, g_new, g), accept_prob)

    mu = math.log(10.0 * init_step_size)
    log_eps = torch.full((C,), math.log(init_step_size), dtype=q.dtype,
                         device=q.device)
    log_eps_bar, h_bar = log_eps, torch.zeros_like(log_eps)
    for k in range(num_warmup):
        q, lp, g, accept_prob = kernel(k, q, lp, g, torch.exp(log_eps))
        if accept_reduce is not None:
            accept_prob = accept_reduce(accept_prob)
        log_eps, log_eps_bar, h_bar = dual_averaging_update(
            log_eps_bar, h_bar, accept_prob, k + 1.0, mu, target_accept)
    step_size = torch.exp(log_eps_bar)
    qs, accepts, lps = [], [], []
    for k in range(num_samples):
        q, lp, g, accept_prob = kernel(num_warmup + k, q, lp, g, step_size)
        qs.append(q)
        accepts.append(accept_prob)
        lps.append(lp)
    return (torch.stack(qs, dim=1), torch.stack(accepts, dim=1), step_size,
            torch.stack(lps, dim=1))


def hmc_chains(logprob_fn: Callable, q0s: Any, generator,
               num_samples: int = 500, num_warmup: int = 200,
               num_leapfrog: int = 16, init_step_size: float = 0.1,
               target_accept: float = 0.8) -> HMCResult:
    """C independent chains as one batch: ``q0s`` a tree with every leaf
    [C, ...], ``logprob_fn`` maps such a tree to [C]. ``generator`` is a
    ``torch.Generator`` on the chains' device (where the JAX package takes
    C keys) or a draw source ``t -> (normals [C, dim], uniforms [C])``.
    Each chain adapts its own step size. Returns samples with leaves
    [C, num_samples, ...], accept_prob and log_probs [C, num_samples],
    step_size [C]."""
    q, unravel = ravel_tree(q0s, batch_ndim=1)
    qs, accepts, step_size, lps = _hmc(
        value_and_grad(logprob_fn, unravel), q, _source(generator, q),
        num_samples, num_warmup, num_leapfrog, init_step_size, target_accept)
    return HMCResult(unravel(qs), accepts, step_size, lps)


def hmc(logprob_fn: Callable, q0: Any, generator, num_samples: int = 500,
        num_warmup: int = 200, num_leapfrog: int = 16,
        init_step_size: float = 0.1, target_accept: float = 0.8
        ) -> HMCResult:
    """Single-chain HMC: ``logprob_fn`` maps the tree ``q0`` to a scalar;
    :func:`hmc_chains` with C = 1, the chain axis dropped."""
    q, unravel = ravel_tree(q0)
    q = q[None]
    qs, accepts, step_size, lps = _hmc(
        value_and_grad(single_chain(logprob_fn), unravel), q,
        _source(generator, q), num_samples, num_warmup, num_leapfrog,
        init_step_size, target_accept)
    return HMCResult(unravel(qs[0]), accepts[0], step_size[0], lps[0])


def gather_chains(tree, mesh, axis: str):
    """Every rank's chains (leaves [c, ...], bool included) concatenated
    along the chain axis in rank order, on every rank."""
    from gaussianprocessfundamentals_tpu_torch.parallel.meshes import (
        all_gather_rows,
    )

    def one(t):
        if t.dtype == torch.bool:
            return all_gather_rows(t.to(torch.uint8), mesh, axis).bool()
        return all_gather_rows(t, mesh, axis)

    return tree_map(one, tree)


def rank_chain(q0s: Any, mesh, axis: str):
    """This rank's chain of ``q0s`` (leaves [P, ...]) as a batch of one,
    checking one chain per rank."""
    P, i = mesh.size(axis), mesh.index(axis)
    chains = ravel_tree(q0s, batch_ndim=1)[0].shape[0]
    if chains != P:
        raise ValueError(f"{chains} chains on a {axis} axis of {P} ranks: "
                         "the collective form runs one chain per rank")
    return tree_map(lambda l: l[i:i + 1], q0s)


def hmc_chains_collective(logprob_fn: Callable, q0s: Any, generator, mesh,
                          axis: str = "dp", num_samples: int = 500,
                          num_warmup: int = 200, num_leapfrog: int = 16,
                          init_step_size: float = 0.1,
                          target_accept: float = 0.8) -> HMCResult:
    """One chain per rank of ``axis`` (``q0s`` leaves [P, ...]; rank i runs
    chain i), the warmup acceptance averaged over the ranks (one
    all-reduce per warmup transition) before dual averaging, so all chains
    share one collectively adapted step size. ``logprob_fn`` maps one
    chain's tree to a scalar; ``generator`` is this rank's
    ``torch.Generator`` or draw source ``t -> (normals [1, dim],
    uniforms [1])``. Every rank returns all P chains, as ``hmc_chains``
    would (leaves [P, num_samples, ...])."""
    from gaussianprocessfundamentals_tpu_torch.parallel.meshes import (
        all_reduce_mean,
    )

    q, unravel = ravel_tree(rank_chain(q0s, mesh, axis), batch_ndim=1)
    qs, accepts, step_size, lps = _hmc(
        value_and_grad(single_chain(logprob_fn), unravel), q,
        _source(generator, q), num_samples, num_warmup, num_leapfrog,
        init_step_size, target_accept,
        accept_reduce=lambda a: all_reduce_mean(a, mesh, axis))
    qs, accepts, step_size, lps = gather_chains(
        (qs, accepts, step_size, lps), mesh, axis)
    return HMCResult(unravel(qs), accepts, step_size, lps)


# --- diagnostics -----------------------------------------------------------

def potential_scale_reduction(x) -> torch.Tensor:
    """Split-R̂ over [chains, samples] scalar traces (Gelman-Rubin)."""
    x = torch.as_tensor(x)
    c, s = x.shape
    half = s // 2
    x = torch.stack([x[:, :half], x[:, half:2 * half]]).reshape(2 * c, half)
    chain_means = x.mean(dim=1)
    chain_vars = x.var(dim=1, correction=1)
    w = chain_vars.mean()
    b = half * chain_means.var(correction=1)
    var_est = (half - 1) / half * w + b / half
    return torch.sqrt(var_est / w)


def effective_sample_size(x, max_lag: int = 100) -> torch.Tensor:
    """Crude ESS from summed autocorrelations over [chains, samples]."""
    x = torch.as_tensor(x)
    c, s = x.shape
    xc = x - x.mean(dim=1, keepdim=True)
    var = (xc * xc).mean()
    max_lag = min(max_lag, s - 1)
    rhos = torch.stack([torch.mean(xc[:, :s - lag] * xc[:, lag:]) / var
                        for lag in range(1, max_lag)])
    rhos = torch.where(rhos > 0, rhos, 0.0)
    return c * s / (1.0 + 2.0 * torch.sum(rhos))
