"""Sharded covariance algebra: row-panel Grams, the distributed matvec and
CG solve, the sharded dense NLL, and the restart-sharded training step.

Counterpart of ``gaussianprocessfundamentals_tpu/parallel/sharded.py``
(``:31-98``). x's rows are split over the ``tp`` axis of a
:class:`.meshes.Mesh`; each rank builds its [n/P, n] panel of K from the
replicated x with no communication, so the O(n²) K never lives on one rank
until a Cholesky needs it whole. The functions use the kernel's installed
hyperparameters; every rank calls them with the same arguments.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
from gaussianprocessfundamentals_tpu_torch.linalg.cg import cg_solve
from gaussianprocessfundamentals_tpu_torch.ops.cuda_dense_gram import (
    dense_gram_for,
)
from gaussianprocessfundamentals_tpu_torch.parallel.meshes import (
    GatherRows,
    Mesh,
    agree_any,
    all_gather_rows,
    pad_to,
    row_range,
    sum_grads_tree,
)
from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def _differentiating(kernel) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(kernel.get_params()))


def sharded_gram(kernel, x: torch.Tensor, mesh: Mesh, axis: str = "tp"
                 ) -> torch.Tensor:
    """This rank's row panel K(x_loc, x) [stop − start, n] of the row-
    sharded K (:func:`.meshes.row_range`): K5/K6 on a card when nothing
    needs its gradient, else ``kernel.gram``."""
    start, stop, _ = row_range(x.shape[0], mesh, axis)
    if _differentiating(kernel):
        return kernel.gram(x[start:stop], x)
    return dense_gram_for(kernel, x[start:stop], x)


def sharded_matvec(K_panel: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis: str = "tp") -> torch.Tensor:
    """K @ v from this rank's row panel of K (v replicated): the panel
    products are all-gathered into the replicated result."""
    n = K_panel.shape[1]
    _, _, rows = row_range(n, mesh, axis)
    return all_gather_rows(pad_to(K_panel @ v, rows), mesh, axis)[:n]


def sharded_nll(kernel, x: torch.Tensor, y: torch.Tensor, noise,
                jitter: float, mesh: Mesh, axis: str = "tp") -> torch.Tensor:
    """The exact NLL with a row-sharded Gram build, differentiable.

    Each rank builds its panel, the panels are gathered into K on every
    rank, and the Cholesky runs replicated. The gradient flows back
    through the gather (:class:`.meshes.GatherRows`: each rank keeps its
    own panel's rows) into the panel, and the hyperparameters' gradients
    are summed over the ranks (:class:`.meshes.SumGrads`): every rank ends
    with the whole gradient, counted once.
    """
    n = x.shape[0]
    start, stop, rows = row_range(n, mesh, axis)
    before = kernel.get_params()
    kernel.set_params(sum_grads_tree(before, mesh, axis))
    try:
        panel = kernel.gram(x[start:stop], x)
    finally:
        kernel.set_params(before)
    K = GatherRows.apply(pad_to(panel, rows), mesh, axis)[:n]
    return chol.nll(K, y, noise, jitter)


def sharded_cg_solve(kernel, x: torch.Tensor, b: torch.Tensor, noise,
                     jitter: float, mesh: Mesh, axis: str = "tp",
                     tol: float = 1e-6, max_iters: Optional[int] = None
                     ) -> torch.Tensor:
    """Matrix-free CG solve of (K + (σ² + jitter)·I)v = b with the rank's
    resident row panel: memory O(n²/P) per rank, one all-gather of a
    vector per iteration. The loop's exit is settled across the ranks."""
    with torch.no_grad():
        K = sharded_gram(kernel, x, mesh, axis)
    sigma2 = torch.as_tensor(noise, dtype=x.dtype, device=x.device) + jitter
    return cg_solve(lambda v: sharded_matvec(K, v, mesh, axis) + sigma2 * v,
                    b, tol=tol, max_iters=max_iters,
                    any_active=lambda a: agree_any(a, mesh, axis))


class Adam(NamedTuple):
    """optax.adam's update as two functions of a params tree (``init``,
    ``update(grads, state, params) -> (updates, state)``), for the
    restart-batched step."""

    init: Callable
    update: Callable


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Adam:
    """Adam with bias correction (optax.adam's arithmetic) over trees whose
    leaves carry a leading restart axis; the step count is per restart."""

    def init(params):
        zeros = tree_map(torch.zeros_like, params)
        lead = tree_leaves(params)[0].shape[0]
        return {"count": torch.zeros(lead, dtype=torch.int64,
                                     device=tree_leaves(params)[0].device),
                "mu": zeros, "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        count = state["count"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["nu"],
                      grads)

        def step(m, v):
            c = count.reshape((-1,) + (1,) * (m.ndim - 1)).to(m.dtype)
            m_hat = m / (1 - b1 ** c)
            v_hat = v / (1 - b2 ** c)
            return -lr * m_hat / (torch.sqrt(v_hat) + eps)

        return tree_map(step, mu, nu), {"count": count, "mu": mu, "nu": nu}

    return Adam(init, update)


def restart_sharded_fit_step(nll_fn: Callable, uparams_batched,
                             opt_update: Callable, opt_state, mesh: Mesh,
                             axis: str = "dp"):
    """One optimiser step over a batch of restarts, the restarts split over
    the ``dp`` axis: each rank takes the value and gradient of ``nll_fn``
    for its own restarts (``nll_fn`` may shard its Gram over ``tp``), the
    optimiser updates them, and the new parameters, optimiser state and
    losses are all-gathered over ``dp``. ``uparams_batched`` and
    ``opt_state`` are replicated trees whose leaves carry a leading
    restart axis R (a multiple of the dp size); ``opt_update`` is
    optax-style (:func:`adam`). Returns (params, opt_state, losses [R])."""
    R = tree_leaves(uparams_batched)[0].shape[0]
    P = mesh.size(axis)
    if R % P:
        raise ValueError(f"{R} restarts do not split over dp={P}")
    r = R // P
    lo = mesh.index(axis) * r
    local = lambda tree: tree_map(lambda l: l[lo:lo + r], tree)  # noqa: E731
    u_loc = local(uparams_batched)
    losses, grads = [], []
    for i in range(r):
        u_i = tree_map(lambda l: l[i].detach().requires_grad_(True), u_loc)
        loss = nll_fn(u_i)
        leaves = tree_leaves(u_i)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for g, p in zip(gs, leaves)]
        losses.append(loss.detach())
        grads.append(tree_unflatten(u_i, gs))
    g_loc = tree_map(lambda *ls: torch.stack(ls), *grads)
    updates, st_loc = opt_update(g_loc, local(opt_state), u_loc)
    u_new = tree_map(lambda p, d: p + d, u_loc, updates)
    gather = lambda tree: tree_map(  # noqa: E731
        lambda l: all_gather_rows(l, mesh, axis), tree)
    return (gather(u_new), gather(st_loc),
            all_gather_rows(torch.stack(losses), mesh, axis))
