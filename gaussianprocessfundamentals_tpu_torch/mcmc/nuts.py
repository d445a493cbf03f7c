"""The No-U-Turn Sampler (iterative, multinomial), with the chains on a
leading batch axis run in lock step.

Counterpart of ``gaussianprocessfundamentals_tpu/mcmc/nuts.py``:
``_nuts_kernel`` (``:79``), ``nuts`` (``:287``), ``nuts_resume``
(``:383``), ``nuts_chains_resume`` (``:419``), ``nuts_chains_collective``
(``:435``) and ``nuts_chains`` (``:474``). The arithmetic is the JAX package's: multinomial progressive
sampling inside a subtree and biased sampling between trees (Betancourt
2017), the binary-counter checkpoints for the sub-subtree U-turn checks
(even leaf i stores at slot popcount(i); odd leaf i with t trailing ones
checks slots popcount(i)−t … popcount(i)−1), the tree's edges moved only
by a subtree that neither turned nor diverged, a divergence at an energy
error above ``MAX_DELTA_ENERGY``, and the two-phase warmup (identity mass
with Welford moments, then the regularised diagonal mass, the step size
re-adapted by dual averaging from log ε̄ with μ unchanged).

The JAX package vmaps a single-chain ``while_loop`` over the chains, which
runs until every chain has stopped and freezes the stopped ones by select.
The port does the same on the host: the doubling depth and the leaf index
are host integers shared by all C chains (so are the checkpoint slots), the
per-chain state that must not move is kept by ``torch.where`` on the
chains that are still going, and the loop makes one host read per doubling
("is any chain still going?", the ``while_loop`` condition) and none per
leaf. ``logprob_fn`` for the chains maps the stacked tree (every leaf
[C, ...]) to [C]; the single-chain forms run as C = 1. Each transition
carries the chosen leaf's gradient, the number the JAX package recomputes
after every draw.

The random numbers come from a draw source indexed by transition,
``source(t) -> NUTSDraws``: the momentum normals and, per doubling j, a
direction and a merge uniform, per leaf i of doubling j a uniform. So a
chain's draws do not depend on when the other chains stop. A
``torch.Generator`` on the chains' device fills the source in production
(:func:`generator_draws`, one block per transition); the tests replay the
JAX package's key schedule through one.

A chain is resumable from (last q, ε, inv_mass) (:func:`nuts_resume`):
segments of a long chain continue with the adaptation frozen, the
checkpoint/continue form of a chain. (The JAX package split its long
chains so because one large TPU program crashed the worker.)

The collective form (:func:`nuts_chains_collective`) runs one chain per
rank of a mesh axis and averages each warmup acceptance over the ranks
(one all-reduce per transition) before dual averaging. Each rank keeps its
own tree depth: its per-doubling stop steers no collective.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from gaussianprocessfundamentals_tpu_torch.mcmc.hmc import (
    chain_axis,
    dual_averaging_update,
    gather_chains,
    rank_chain,
    select,
    single_chain,
    value_and_grad,
)
from gaussianprocessfundamentals_tpu_torch.utils.tree import ravel_tree

MAX_DELTA_ENERGY = 1000.0


class NUTSResult(NamedTuple):
    samples: Any  # tree, leaves [num_samples, ...] ([C, S, ...] for chains)
    accept_stat: torch.Tensor  # [num_samples] mean leaf acceptance
    step_size: torch.Tensor
    num_steps: torch.Tensor  # [num_samples] leapfrog steps per draw
    diverging: torch.Tensor  # [num_samples] bool
    log_probs: torch.Tensor
    # the adapted diagonal inverse mass (flat): with step_size and the last
    # sample it resumes the chain (:func:`nuts_resume`)
    inv_mass: Any = None
    # lock-step doublings over the call, warmup included: the host reads
    # the call made (one per doubling)
    doublings: int = 0


class NUTSDraws(NamedTuple):
    """The random numbers of one transition of C chains."""

    momentum: torch.Tensor  # [C, dim] standard normals
    direction: torch.Tensor  # [max_depth, C] uniforms: < 0.5 goes left
    merge: torch.Tensor  # [max_depth, C] uniforms: old tree or new subtree
    leaf: torch.Tensor  # [2^max_depth − 1, C]: doubling j, leaf i at 2^j−1+i


def generator_draws(generator: torch.Generator, like: torch.Tensor,
                    max_depth: int) -> Callable:
    """The production draw source: per transition one block of normals and
    one of uniforms from ``generator`` (on ``like``'s device, [C, dim])."""
    C, dim = like.shape
    n_u = 2 * max_depth + (1 << max_depth) - 1

    def draw(t: int) -> NUTSDraws:
        m = torch.randn((C, dim), generator=generator, dtype=like.dtype,
                        device=like.device)
        u = torch.rand((n_u, C), generator=generator, dtype=like.dtype,
                       device=like.device)
        return NUTSDraws(m, u[:max_depth], u[max_depth:2 * max_depth],
                         u[2 * max_depth:])

    return draw


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _is_turning(q_l, p_l, q_r, p_r, inv_mass):
    # velocities v = M⁻¹p; with diagonal mass M = diag(1/inv_mass)
    dq = q_r - q_l
    return (_dot(dq, inv_mass * p_l) < 0.0) | (_dot(dq, inv_mass * p_r) < 0.0)


def _subtree(lpg, u_leaf, depth: int, tree: dict, right, eps_d, inv_mass,
             energy0, active) -> dict:
    """2^depth leaves outward from the tree's edge on each chain's side;
    the chains where ``active`` is False, and each chain once its subtree
    has turned or diverged, are frozen."""
    q = select(right, tree["q_right"], tree["q_left"])
    p = select(right, tree["p_right"], tree["p_left"])
    g = select(right, tree["g_right"], tree["g_left"])
    zeros = torch.zeros_like(energy0)
    false = torch.zeros_like(active)
    sub = dict(q=q, p=p, g=g, q_cand=q, lp_cand=zeros, g_cand=g,
               logw=torch.full_like(energy0, -torch.inf), turning=false,
               diverging=false, sum_accept=zeros, n=zeros)
    ck_q = [torch.zeros_like(q)] * (depth + 1)  # slots popcount(i) ≤ depth
    ck_p = list(ck_q)
    step = chain_axis(eps_d, q)
    for i in range(1 << depth):
        live = active & ~(sub["turning"] | sub["diverging"])
        p_half = sub["p"] + 0.5 * step * sub["g"]
        q1 = sub["q"] + step * inv_mass * p_half
        lp1, g1 = lpg(q1)
        p1 = p_half + 0.5 * step * g1
        logw_leaf = lp1 - 0.5 * _dot(p1, inv_mass * p1) - energy0
        logw_leaf = torch.where(torch.isnan(logw_leaf), -torch.inf, logw_leaf)
        diverging = logw_leaf < -MAX_DELTA_ENERGY
        accept = torch.clamp_max(torch.exp(logw_leaf), 1.0)
        # progressive multinomial sampling within the subtree
        logw_new = torch.logaddexp(sub["logw"], logw_leaf)
        take = live & (torch.log(u_leaf[i]) < logw_leaf - logw_new)
        # binary-counter checkpoints + U-turn checks
        pc = bin(i).count("1")
        turning = sub["turning"]
        if i % 2 == 0:
            ck_q[pc] = select(live, q1, ck_q[pc])
            ck_p[pc] = select(live, p1, ck_p[pc])
        else:
            trailing = (~i & (i + 1)).bit_length() - 1
            for k in range(pc - trailing, pc):
                turning = turning | (live & _is_turning(ck_q[k], ck_p[k], q1,
                                                        p1, inv_mass))
        sub = dict(
            q=select(live, q1, sub["q"]), p=select(live, p1, sub["p"]),
            g=select(live, g1, sub["g"]),
            q_cand=select(take, q1, sub["q_cand"]),
            lp_cand=torch.where(take, lp1, sub["lp_cand"]),
            g_cand=select(take, g1, sub["g_cand"]),
            logw=torch.where(live, logw_new, sub["logw"]),
            turning=turning, diverging=sub["diverging"] | (live & diverging),
            sum_accept=sub["sum_accept"] + torch.where(live, accept, 0.0),
            n=sub["n"] + live.to(energy0.dtype),
        )
    return sub


def _merge(tree: dict, sub: dict, right, u_merge, inv_mass, active) -> dict:
    """The tree after a doubling: biased progressive sampling between the
    old tree and the new subtree, the edges moved only when the subtree
    neither turned nor diverged, then the whole tree's U-turn check; the
    chains where ``active`` is False keep their tree."""
    ok = ~(sub["turning"] | sub["diverging"])
    take = ok & (torch.log(u_merge) < sub["logw"] - tree["logw"])
    left_new, right_new = ok & ~right, ok & right
    new = dict(
        q_cand=select(take, sub["q_cand"], tree["q_cand"]),
        lp_cand=torch.where(take, sub["lp_cand"], tree["lp_cand"]),
        g_cand=select(take, sub["g_cand"], tree["g_cand"]),
        logw=torch.where(ok, torch.logaddexp(tree["logw"], sub["logw"]),
                         tree["logw"]),
    )
    for side, moved in (("left", left_new), ("right", right_new)):
        for v in "qpg":
            new[f"{v}_{side}"] = select(moved, sub[v], tree[f"{v}_{side}"])
    turning_global = _is_turning(new["q_left"], new["p_left"],
                                 new["q_right"], new["p_right"], inv_mass)
    new.update(turning=sub["turning"] | turning_global,
               diverging=sub["diverging"],
               sum_accept=tree["sum_accept"] + sub["sum_accept"],
               n_leaves=tree["n_leaves"] + sub["n"])
    return {k: select(active, v, tree[k]) for k, v in new.items()}


def nuts_transition(lpg: Callable, max_depth: int, draws: NUTSDraws, q0,
                    lp0, g0, eps, inv_mass):
    """One NUTS transition of C chains from q0 [C, dim] (log-prob lp0 [C],
    gradient g0) at step sizes eps [C] and inverse masses [C, dim]. Returns
    (q, lp, ∇lp, accept_stat [C], n_steps [C], diverging [C], doublings)."""
    p0 = draws.momentum / torch.sqrt(inv_mass)
    energy0 = lp0 - 0.5 * _dot(p0, inv_mass * p0)
    zeros = torch.zeros_like(lp0)
    false = torch.zeros(lp0.shape, dtype=torch.bool, device=lp0.device)
    tree = dict(q_cand=q0, lp_cand=lp0, g_cand=g0, logw=zeros,
                q_left=q0, p_left=p0, g_left=g0,
                q_right=q0, p_right=p0, g_right=g0,
                turning=false, diverging=false, sum_accept=zeros,
                n_leaves=zeros)
    active = ~false
    doublings = 0
    for j in range(max_depth):
        right = draws.direction[j] >= 0.5
        eps_d = torch.where(right, eps, -eps)
        sub = _subtree(lpg, draws.leaf[(1 << j) - 1:], j, tree, right, eps_d,
                       inv_mass, energy0, active)
        tree = _merge(tree, sub, right, draws.merge[j], inv_mass, active)
        doublings += 1
        active = active & ~(tree["turning"] | tree["diverging"])
        if not bool(active.any()):  # the one host read of a doubling
            break
    accept_stat = tree["sum_accept"] / torch.clamp_min(tree["n_leaves"], 1.0)
    return (tree["q_cand"], tree["lp_cand"], tree["g_cand"], accept_stat,
            tree["n_leaves"], tree["diverging"], doublings)


def _source(generator, q, max_depth: int) -> Callable:
    if isinstance(generator, torch.Generator):
        return generator_draws(generator, q, max_depth)
    return generator


def _sample(lpg, max_depth, source, t0: int, num_samples: int, q, lp, g,
            eps, inv_mass):
    """``num_samples`` transitions at frozen (eps, inv_mass), drawing from
    ``source(t0 + k)``; returns the stacked records and the doublings."""
    rec = {k: [] for k in ("q", "accept", "n_steps", "div", "lp")}
    doublings = 0
    for k in range(num_samples):
        q, lp, g, accept, n_steps, div, d = nuts_transition(
            lpg, max_depth, source(t0 + k), q, lp, g, eps, inv_mass)
        doublings += d
        for key, v in zip(rec, (q, accept, n_steps, div, lp)):
            rec[key].append(v)
    return {k: torch.stack(v, dim=1) for k, v in rec.items()}, doublings


def _nuts(lpg, q, source, num_samples, num_warmup, max_depth,
          init_step_size, target_accept, accept_reduce=None):
    """Two-phase warmup then sampling over C chains from q [C, dim].
    ``accept_reduce`` maps each warmup acceptance before dual averaging
    (the collective form's mean over the ranks)."""
    lp, g = lpg(q)
    mu = math.log(10.0 * init_step_size)
    n1 = max(num_warmup // 2, 1)
    n2 = max(num_warmup - n1, 1)
    doublings = 0

    def warmup(t0, n, q, lp, g, log_eps, inv_mass):
        # dual averaging of each chain's step size, and Welford moments of q
        nonlocal doublings
        log_eps_bar, h_bar = log_eps, torch.zeros_like(log_eps)
        w_mean, w_m2 = torch.zeros_like(q), torch.zeros_like(q)
        for k in range(n):
            q, lp, g, accept, _, _, d = nuts_transition(
                lpg, max_depth, source(t0 + k), q, lp, g, torch.exp(log_eps),
                inv_mass)
            doublings += d
            if accept_reduce is not None:
                accept = accept_reduce(accept)
            t = k + 1.0
            log_eps, log_eps_bar, h_bar = dual_averaging_update(
                log_eps_bar, h_bar, accept, t, mu, target_accept)
            delta = q - w_mean
            w_mean = w_mean + delta / t
            w_m2 = w_m2 + delta * (q - w_mean)
        return q, lp, g, log_eps_bar, w_m2

    log_e0 = torch.full(lp.shape, math.log(init_step_size), dtype=q.dtype,
                        device=q.device)
    # (1) step size at identity mass while accumulating the moments of q
    q, lp, g, log_eps_bar, w_m2 = warmup(0, n1, q, lp, g, log_e0,
                                         torch.ones_like(q))
    # (2) the diagonal mass from phase 1's variance (Stan's regularisation),
    # the step size re-adapted from log ε̄
    cnt = float(n1)
    var = w_m2 / max(cnt - 1.0, 1.0)
    inv_mass = (cnt / (cnt + 5.0)) * var + (5.0 / (cnt + 5.0)) * 1e-3
    inv_mass = torch.where(inv_mass > 0, inv_mass, 1.0)
    q, lp, g, log_eps_bar, _ = warmup(n1, n2, q, lp, g, log_eps_bar, inv_mass)
    eps = torch.exp(log_eps_bar)
    rec, d = _sample(lpg, max_depth, source, n1 + n2, num_samples, q, lp, g,
                     eps, inv_mass)
    return rec, eps, inv_mass, doublings + d


def _result(rec, unravel, eps, inv_mass, doublings, chain=None):
    """The NUTSResult of the stacked records; ``chain=0`` drops the chain
    axis."""
    pick = (lambda v: v) if chain is None else (lambda v: v[chain])
    return NUTSResult(unravel(pick(rec["q"])), pick(rec["accept"]), pick(eps),
                      pick(rec["n_steps"]), pick(rec["div"]),
                      pick(rec["lp"]), pick(inv_mass), doublings)


def nuts_chains(logprob_fn: Callable, q0s: Any, generator,
                num_samples: int = 500, num_warmup: int = 300,
                max_depth: int = 8, init_step_size: float = 0.1,
                target_accept: float = 0.8) -> NUTSResult:
    """C chains in lock step: ``q0s`` a tree with every leaf [C, ...],
    ``logprob_fn`` maps such a tree to [C]. ``generator`` is a
    ``torch.Generator`` on the chains' device (where the JAX package takes
    C keys) or a draw source ``t -> NUTSDraws``. Each chain adapts its own
    step size and mass. Returns samples with leaves [C, num_samples, ...],
    the per-draw records [C, num_samples], step_size [C] and inv_mass
    [C, dim]."""
    q, unravel = ravel_tree(q0s, batch_ndim=1)
    rec, eps, inv_mass, doublings = _nuts(
        value_and_grad(logprob_fn, unravel), q,
        _source(generator, q, max_depth), num_samples, num_warmup, max_depth,
        init_step_size, target_accept)
    return _result(rec, unravel, eps, inv_mass, doublings)


def nuts_chains_collective(logprob_fn: Callable, q0s: Any, generator, mesh,
                           axis: str = "dp", num_samples: int = 500,
                           num_warmup: int = 300, max_depth: int = 8,
                           init_step_size: float = 0.1,
                           target_accept: float = 0.8) -> NUTSResult:
    """One NUTS chain per rank of ``axis`` (``q0s`` leaves [P, ...]; rank i
    runs chain i), each warmup acceptance averaged over the ranks before
    dual averaging, so all chains share one collectively adapted step size
    (each keeps its own mass). ``logprob_fn`` maps one chain's tree to a
    scalar; ``generator`` is this rank's ``torch.Generator`` or draw source
    ``t -> NUTSDraws`` of one chain. Every rank returns all P chains
    (leaves [P, num_samples, ...]); ``doublings`` is this rank's."""
    from gaussianprocessfundamentals_tpu_torch.parallel.meshes import (
        all_reduce_mean,
    )

    q, unravel = ravel_tree(rank_chain(q0s, mesh, axis), batch_ndim=1)
    rec, eps, inv_mass, doublings = _nuts(
        value_and_grad(single_chain(logprob_fn), unravel), q,
        _source(generator, q, max_depth), num_samples, num_warmup, max_depth,
        init_step_size, target_accept,
        accept_reduce=lambda a: all_reduce_mean(a, mesh, axis))
    rec, eps, inv_mass = gather_chains((rec, eps, inv_mass), mesh, axis)
    return _result(rec, unravel, eps, inv_mass, doublings)


def nuts(logprob_fn: Callable, q0: Any, generator, num_samples: int = 500,
         num_warmup: int = 300, max_depth: int = 8,
         init_step_size: float = 0.1, target_accept: float = 0.8
         ) -> NUTSResult:
    """Single-chain NUTS over a tree position: ``logprob_fn`` maps ``q0``'s
    tree to a scalar; :func:`nuts_chains` with C = 1, the chain axis
    dropped."""
    q, unravel = ravel_tree(q0)
    q = q[None]
    rec, eps, inv_mass, doublings = _nuts(
        value_and_grad(single_chain(logprob_fn), unravel), q,
        _source(generator, q, max_depth), num_samples, num_warmup, max_depth,
        init_step_size, target_accept)
    return _result(rec, unravel, eps, inv_mass, doublings, chain=0)


def _resume(lpg, q, unravel, generator, num_samples, step_size, inv_mass,
            max_depth, chain=None):
    eps = torch.as_tensor(step_size, dtype=q.dtype,
                          device=q.device).reshape(q.shape[0])
    inv_mass = torch.as_tensor(inv_mass, dtype=q.dtype,
                               device=q.device).reshape(q.shape)
    lp, g = lpg(q)
    rec, doublings = _sample(lpg, max_depth, _source(generator, q, max_depth),
                             0, num_samples, q, lp, g, eps, inv_mass)
    return _result(rec, unravel, eps, inv_mass, doublings, chain)


def nuts_chains_resume(logprob_fn: Callable, q0s: Any, generator,
                       num_samples: int, step_sizes, inv_masses,
                       max_depth: int = 8) -> NUTSResult:
    """:func:`nuts_resume` of C chains in lock step: ``step_sizes`` [C] and
    ``inv_masses`` [C, dim] from an earlier :func:`nuts_chains`."""
    q, unravel = ravel_tree(q0s, batch_ndim=1)
    return _resume(value_and_grad(logprob_fn, unravel), q, unravel,
                   generator, num_samples, step_sizes, inv_masses, max_depth)


def nuts_resume(logprob_fn: Callable, q0: Any, generator, num_samples: int,
                step_size, inv_mass, max_depth: int = 8) -> NUTSResult:
    """Continue a chain from ``q0`` with FROZEN adaptation (``step_size`` /
    ``inv_mass`` from an earlier :func:`nuts`): no warmup, so a long chain
    is a series of calls whose draws concatenate for R̂ and ESS, and a
    chain persisted as (last q, step_size, inv_mass) continues later."""
    q, unravel = ravel_tree(q0)
    return _resume(value_and_grad(single_chain(logprob_fn), unravel),
                   q[None], unravel, generator, num_samples, step_size,
                   inv_mass, max_depth, chain=0)
