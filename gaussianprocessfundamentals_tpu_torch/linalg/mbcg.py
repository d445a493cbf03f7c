"""Modified batched conjugate gradients (mBCG) and the SLQ log-determinant.

Counterpart of ``gaussianprocessfundamentals_tpu/linalg/mbcg.py``: ``mbcg``
(``:43-181``), one CG run against all columns of B at once, returning the
per-column best-residual iterates and the α/β recurrence;
``lanczos_tridiag_from_cg`` (``:184``) and the stochastic Lanczos
quadrature log-determinant. The CG loop is a Python loop; with
``early_exit`` it reads one flag from the device per iteration to stop once
every column is done.

One :func:`slq_logdet` replaces the JAX package's three forms (``:210``,
``slq_logdet_device`` ``:405`` with its Jacobi eigensolver, and
``slq_logdet_host`` ``:425``): a batched float64 ``torch.linalg.eigh`` of
the [r, t, t] tridiagonals on the tensors' own device. The Jacobi solver
and the host round trip only kept a remote TPU's program small.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

# consecutive >4×best residual excursions before a column counts as
# exhausted: legitimately converging columns show 8-15+ in a row mid-run,
# while at the float32 floor divergence persists indefinitely
_DIVERGE_FACTOR = 4.0
_EXHAUST_ITERS = 25


class MBCGResult(NamedTuple):
    solves: torch.Tensor  # [n, r] best-residual iterates of A⁻¹B
    alphas: torch.Tensor  # [max_iters, r] CG step sizes
    betas: torch.Tensor  # [max_iters, r] CG conjugacy coefficients
    resid_norm: torch.Tensor  # [r] residual norms of the returned iterates
    iters: int  # iterations executed


def mbcg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    B: torch.Tensor,
    max_iters: int = 100,
    tol: float = 1e-8,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    early_exit: bool = False,
    all_done: Optional[Callable[[torch.Tensor], bool]] = None,
) -> MBCGResult:
    """Batched CG on A X = B with B: [n, r]; ``matvec`` maps [n, r] → [n, r].

    Finite-precision hardening, as in the JAX package: a column freezes when
    pAp ≤ 0 or rᵀP⁻¹r ≤ 0 (its Krylov space is exhausted at this
    precision), when its residual drops below ``tol``, or when it has
    bounced above 4× its best residual for 25 consecutive iterations after
    reaching 1% of ‖b‖. The returned solves are each column's best iterate.

    ``all_done(done) -> bool`` replaces the early exit's host read of
    ``done.all()``: under a mesh it settles the exit across the ranks, so
    every rank runs the same number of matvecs (their collectives must
    match).
    """
    n, r = B.shape
    M = precond if precond is not None else (lambda v: v)

    X = torch.zeros_like(B)
    R = B
    Z = M(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    b_norm = torch.linalg.norm(B, dim=0)
    done = torch.zeros(r, dtype=torch.bool, device=B.device)
    bX, bR = X, b_norm
    stall = torch.zeros(r, dtype=torch.int32, device=B.device)
    alphas = torch.zeros((max_iters, r), dtype=B.dtype, device=B.device)
    betas = torch.zeros_like(alphas)
    zero = torch.zeros((), dtype=B.dtype, device=B.device)
    one = torch.ones((), dtype=B.dtype, device=B.device)

    iters = 0
    for i in range(max_iters):
        if early_exit and (all_done(done) if all_done is not None
                           else bool(done.all())):
            break
        AP = matvec(P)
        pAp = torch.sum(P * AP, dim=0)
        bad = (pAp <= 0.0) | ~torch.isfinite(pAp)
        # columns frozen before this step plus this step's pAp breakdown
        done_alpha = done | bad
        alpha = rz / torch.where(pAp > 0, pAp, one)
        alpha = torch.where(done_alpha, zero, alpha)
        X = X + alpha * P
        R_new = R - alpha * AP
        Z_new = M(R_new)
        rz_new = torch.sum(R_new * Z_new, dim=0)
        # rᵀP⁻¹r ≤ 0 is impossible for SPD P in exact arithmetic: the
        # column sits at its attainable floor
        done = done_alpha | (rz_new <= 0.0)
        beta = rz_new / torch.where(rz > 0, rz, one)
        beta = torch.where(done, zero, beta)
        P = Z_new + beta * P
        resid = torch.linalg.norm(R_new, dim=0)
        # a column whose rz froze THIS step still took a valid step, so its
        # iterate stays recordable: gate on done_alpha, not done
        improved = (resid < bR) & torch.isfinite(resid) & ~done_alpha
        bX = torch.where(improved[None, :], X, bX)
        bR = torch.where(improved, resid, bR)
        excursion = (bR < 0.01 * b_norm) & ~(resid <= _DIVERGE_FACTOR * bR)
        stall = torch.where(excursion, stall + 1, torch.zeros_like(stall))
        done = done | (resid < tol) | (stall >= _EXHAUST_ITERS)
        done = done | ~torch.isfinite(resid)
        R = torch.where(torch.isfinite(R_new), R_new, R)
        Z, rz = Z_new, rz_new
        alphas[i] = alpha
        betas[i] = beta
        iters = i + 1
    return MBCGResult(bX, alphas, betas, bR, iters)


def lanczos_tridiag_from_cg(alphas: torch.Tensor, betas: torch.Tensor):
    """CG coefficients → Lanczos tridiagonal (diag [t, r], offdiag
    [t-1, r]) per column:

        T_jj = 1/α_j + β_{j-1}/α_{j-1},   T_{j,j+1} = √β_j / α_j.

    Columns that converged early (α = 0 tail) or whose coefficients went
    non-finite get identity rows, so their estimate is biased, not NaN.
    """
    one = torch.ones((), dtype=alphas.dtype, device=alphas.device)
    safe_a = torch.where(alphas != 0, alphas, one)
    prev_ba = torch.cat([torch.zeros_like(alphas[:1]),
                         betas[:-1] / safe_a[:-1]], dim=0)
    diag = 1.0 / safe_a + prev_ba
    off = torch.sqrt(torch.clamp_min(betas, 0.0)) / safe_a
    dead = (alphas == 0) | ~torch.isfinite(alphas) | ~torch.isfinite(betas)
    diag = torch.where(dead | ~torch.isfinite(diag), one, diag)
    off = torch.where(dead | ~torch.isfinite(off), torch.zeros_like(off), off)
    return diag, off[:-1]


def slq_logdet(alphas: torch.Tensor, betas: torch.Tensor,
               z_weights: torch.Tensor) -> torch.Tensor:
    """Stochastic Lanczos quadrature estimate of log|A| from a CG run on
    probe columns: mean over columns of ‖z‖²_w · e₁ᵀ log(T) e₁, where
    ``z_weights`` are the probes' e₁ weights (zᵀz, or zᵀP⁻¹z for
    preconditioned probes). Returns a float64 scalar on the tensors'
    device."""
    diag, off = lanczos_tridiag_from_cg(alphas.double(), betas.double())
    T = (torch.diag_embed(diag.T) + torch.diag_embed(off.T, offset=1)
         + torch.diag_embed(off.T, offset=-1))  # [r, t, t]
    w, V = torch.linalg.eigh(T)
    w = torch.clamp_min(w, 1e-300)
    tau = V[:, 0, :] ** 2
    vals = z_weights.double() * torch.sum(tau * torch.log(w), dim=-1)
    return vals.mean()
