"""Linear conjugate gradients (matrix-free, one right-hand side).

Counterpart of ``gaussianprocessfundamentals_tpu/linalg/cg.py``:
``cg_solve`` (``:18``), ``cg_solve_dense`` (``:69``) and
``cg_solve_implicit`` (``:73``). The convergence test is the JAX package's
absolute one, max|r| < tol, with an iteration cap and a NaN bail-out that
returns the last finite iterate.

The loop runs on the device without a host read per iteration: every
iteration updates the JAX loop's condition as a device bool that stays
false once false, the iterate is frozen where it is false, and the host
reads that bool once every ``_CHECK_EVERY`` iterations to stop. The
iterate returned is the one the JAX ``while_loop`` returns.

``cg_solve_implicit`` is a ``torch.autograd.Function``, the counterpart of
``lax.custom_linear_solve(symmetric=True)``: its backward solves the same
SPD system for the cotangent instead of unrolling the iterations. A Function
cannot see the tensors a closure holds, so the operator's parameter tensors
are its explicit inputs: ``matvec(v, *params)``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

# iterations between two host reads of the loop's condition
_CHECK_EVERY = 8


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-2,
    max_iters: Optional[int] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    stats: Optional[dict] = None,
    any_active: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Solve A x = b for SPD A given only ``matvec``; b: [n] (one right-hand
    side: batches go through :func:`..mbcg.mbcg`).

    Iterates while max|r| ≥ ``tol``, fewer than ``max_iters`` (default n)
    iterations have run and no residual entry is NaN; an iteration whose
    residual turns NaN keeps the previous iterate. ``stats``, when given,
    gets the iterations run appended to its ``"iters"`` list.
    ``any_active(active)`` settles the loop's exit across the ranks of a
    mesh (the matvec's collectives must run as often on each).
    """
    if b.ndim != 1:
        raise ValueError("cg_solve is single-RHS; use linalg.mbcg for batches")
    n = b.shape[-1]
    max_iters = n if max_iters is None else max_iters
    M = precond if precond is not None else (lambda v: v)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = torch.sum(r * z)
    # the JAX loop's condition, kept false once it turns false: past that
    # point x is frozen, and r, p, rz run on unread
    active = torch.max(torch.abs(r)) >= tol
    iters = torch.zeros((), dtype=torch.int64, device=b.device)
    for i in range(max_iters):
        if i % _CHECK_EVERY == 0 and not bool(
                active if any_active is None else any_active(active)):
            break
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        a = rz / torch.where(denom == 0, one, denom)
        x_new = x + a * p
        r = r - a * Ap
        z = M(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(rz == 0, one, rz)
        p = z + beta * p
        rz = rz_new
        ok = ~torch.any(torch.isnan(r))
        x = torch.where(active & ok, x_new, x)
        iters = iters + active.to(torch.int64)
        active = active & ok & (torch.max(torch.abs(r)) >= tol)
    if stats is not None:
        stats.setdefault("iters", []).append(int(iters))
    return x


def cg_solve_dense(A: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    return cg_solve(lambda v: A @ v, b, **kw)


class _ImplicitCG(torch.autograd.Function):
    """x = A(θ)⁻¹b by :func:`cg_solve`; backward by the implicit function
    theorem for SPD A: λ = A⁻¹ḡ (the same solver), b̄ = λ, and θ̄ the
    gradient of −λᵀA(θ)x with λ and x held fixed."""

    @staticmethod
    def forward(ctx, matvec, kw, b, *params):
        x = cg_solve(lambda v: matvec(v, *params), b, **kw)
        ctx.matvec, ctx.kw = matvec, kw
        ctx.save_for_backward(x, *params)
        return x

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        lam = cg_solve(lambda v: ctx.matvec(v, *params), g, **ctx.kw)
        wanted = [i for i in range(len(params)) if ctx.needs_input_grad[3 + i]]
        grads = [None] * len(params)
        if wanted:
            with torch.enable_grad():
                leaves = [p.detach().requires_grad_(True) for p in params]
                s = -torch.sum(lam.detach() * ctx.matvec(x.detach(), *leaves))
                got = torch.autograd.grad(s, [leaves[i] for i in wanted],
                                          allow_unused=True)
            for i, gi in zip(wanted, got):
                grads[i] = gi
        return (None, None, lam if ctx.needs_input_grad[2] else None, *grads)


def cg_solve_implicit(
    matvec: Callable[..., torch.Tensor],
    b: torch.Tensor,
    params: Sequence[torch.Tensor] = (),
    tol: float = 1e-2,
    max_iters: Optional[int] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Reverse-differentiable CG solve of A(θ)x = b, A SPD, with
    ``matvec(v, *params)`` = A(θ)·v.

    The forward pass is :func:`cg_solve`; gradients come from the implicit
    function theorem (one more solve of the same system, on the
    cotangent), with respect to b and to every tensor of ``params``.
    ``stats`` gets the forward's and then the backward's iteration counts.
    This is what makes CG-based objectives (the SKI MLL) usable inside
    ``fit()``.
    """
    kw = dict(tol=tol, max_iters=max_iters, precond=precond, stats=stats)
    return _ImplicitCG.apply(matvec, kw, b, *params)
