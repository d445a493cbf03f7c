"""Structured Kernel Interpolation (SKI): K̂ = W·K_mm·Wᵀ.

Counterpart of ``gaussianprocessfundamentals_tpu/linalg/ski.py``:
``SKIState`` (``:22``), ``ski_interp`` (``:28``), ``ski_interp_knn``
(``:55``), ``ski_factor`` (``:76``), ``ski_matvec`` (``:82``),
``ski_logdet_approx`` (``:96``), ``toeplitz_matvec`` (``:105``),
``ski_matvec_toeplitz`` (``:131``), ``ski_mll_toeplitz`` (``:142``) and
``ski_mll`` (``:169``). W holds inverse-distance weights over each point's
two nearest inducing points, kept sparse as ([n, 2] indices, [n, 2]
weights): a matvec with K̂ is a scatter (``index_add``), an m×m product
(or a Toeplitz FFT product on an equispaced 1-D grid) and a gather.

Both log likelihoods solve (K̂ + σ²I)α = y by the implicit-gradient CG
(:func:`..cg.cg_solve_implicit`) with the JAX package's absolute test
max|r| < ``cg_tol`` and its cap of 4n iterations.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussianprocessfundamentals_tpu_torch.linalg.cg import cg_solve_implicit
from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import (
    LOG_2PI,
    add_diag,
)
from gaussianprocessfundamentals_tpu_torch.ops.distances import sq_euclidean


class SKIState(NamedTuple):
    idx: torch.Tensor  # [n, 2] neighbour indices into the inducing grid
    w: torch.Tensor  # [n, 2] interpolation weights (rows sum to 1)
    K_mm: torch.Tensor  # [m, m] inducing Gram


def ski_interp(x: torch.Tensor, grid: torch.Tensor):
    """Two-nearest inverse-distance interpolation of x onto the inducing
    set: ([n, 2] indices, [n, 2] weights summing to 1).

    d = 1 (a sorted grid): the neighbours by ``searchsorted``, O(n log m),
    no distance matrix. d > 1: :func:`ski_interp_knn`.
    """
    if x.shape[-1] == 1:
        g = grid[:, 0].contiguous()
        m = g.shape[0]
        x0 = x[:, 0].contiguous()
        # right=False is jnp.searchsorted's side="left"
        hi = torch.clamp(torch.searchsorted(g, x0), 1, m - 1)
        lo = hi - 1
        d_lo = torch.abs(x0 - g[lo])
        d_hi = torch.abs(g[hi] - x0)
        total = d_lo + d_hi
        pos = total > 0
        w_lo = torch.where(pos, d_hi / torch.where(pos, total, 1.0), 0.5)
        idx = torch.stack([lo, hi], dim=-1)
        w = torch.stack([w_lo, 1.0 - w_lo], dim=-1)
        return idx, w
    return ski_interp_knn(x, grid)


def ski_interp_knn(x: torch.Tensor, grid: torch.Tensor):
    """Any-dimension two-nearest-neighbour weights (the reference's
    ``get_weight_matrix``): dense [n, m] squared Euclidean distances, the
    two smallest, weight₁ = d₂/(d₁+d₂).

    Tied distances pick the lowest indices, as ``lax.top_k`` does: two
    ``argmin`` passes (each returns the first minimum), where
    ``torch.topk``'s choice among ties is unspecified."""
    d2 = sq_euclidean(x, grid)  # [n, m]
    i1 = torch.argmin(d2, dim=-1, keepdim=True)
    i2 = torch.argmin(d2.scatter(-1, i1, float("inf")), dim=-1, keepdim=True)
    idx = torch.cat([i1, i2], dim=-1)
    d12 = torch.sqrt(torch.clamp_min(torch.gather(d2, -1, idx), 0.0))
    total = d12[:, 0] + d12[:, 1]
    pos = total > 0
    w1 = torch.where(pos, d12[:, 1] / torch.where(pos, total, 1.0), 0.5)
    return idx, torch.stack([w1, 1.0 - w1], dim=-1)


def ski_factor(kernel, x: torch.Tensor, grid: torch.Tensor) -> SKIState:
    idx, w = ski_interp(x, grid)
    return SKIState(idx, w, kernel.gram(grid, grid))


def _scatter(idx, w, v, m: int) -> torch.Tensor:
    """Wᵀv: the weighted v added into the grid bins."""
    return torch.zeros((m,), dtype=v.dtype, device=v.device).index_add(
        0, idx.reshape(-1), (w * v[:, None]).reshape(-1))


def _gather(idx, w, u) -> torch.Tensor:
    """W·u."""
    return torch.sum(w * u[idx], dim=-1)


def ski_matvec(state: SKIState, noise, v: torch.Tensor) -> torch.Tensor:
    """(W K_mm Wᵀ + σ²I)·v in O(n + m²)."""
    m = state.K_mm.shape[0]
    u = state.K_mm @ _scatter(state.idx, state.w, v, m)
    return _gather(state.idx, state.w, u) + noise * v


def ski_logdet_approx(state: SKIState, n: int, noise) -> torch.Tensor:
    """log|W K_mm Wᵀ + σ²I| approximated by scaling K_mm's eigenvalues by
    n/m (the reference's eigenvalue approximation)."""
    m = state.K_mm.shape[0]
    eig = torch.linalg.eigvalsh(add_diag(state.K_mm, 1e-12))
    scaled = torch.clamp_min(eig * (n / m), 0.0)
    return torch.sum(torch.log(scaled + noise))


def _circulant(first_col: torch.Tensor) -> torch.Tensor:
    """The length-2m circulant embedding [c0..c_{m-1}, 0, c_{m-1}..c1]."""
    return torch.cat([first_col, first_col.new_zeros(1),
                      first_col[1:].flip(0)])


def toeplitz_matvec(first_col: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """T·v for the symmetric Toeplitz T with this first column, by
    circulant embedding and FFT: O(m log m) in place of O(m²). On a 1-D
    equispaced grid every stationary kernel's K_mm is Toeplitz. v: [m] or
    [m, r]."""
    vec = v.ndim == 1
    if vec:
        v = v[:, None]
    m = first_col.shape[0]
    fc = torch.fft.rfft(_circulant(first_col))
    vp = torch.cat([v, torch.zeros_like(v)], dim=0)
    out = torch.fft.irfft(fc[:, None] * torch.fft.rfft(vp, dim=0), n=2 * m,
                          dim=0)
    out = out[:m].to(v.dtype)
    return out[:, 0] if vec else out


def ski_matvec_toeplitz(idx, w, first_col, noise, v):
    """(W·T·Wᵀ + σ²I)·v with a Toeplitz K_mm: O(n + m log m)."""
    m = first_col.shape[0]
    u = toeplitz_matvec(first_col, _scatter(idx, w, v, m))
    return _gather(idx, w, u) + noise * v


def ski_mll_toeplitz(kernel, x, y, grid, noise, jitter: float,
                     cg_tol: float = 1e-6, stats: Optional[dict] = None):
    """SKI log marginal likelihood with the Toeplitz fast matvec (an
    equispaced grid is required) and the circulant-eigenvalue log-det
    (scaled by n/m, as the reference's eigenvalue approximation). ``stats``
    receives the CG iteration counts (:func:`..cg.cg_solve_implicit`)."""
    n = x.shape[0]
    m = grid.shape[0]
    idx, w = ski_interp(x, grid)
    first_col = kernel.gram(grid, grid[:1])[:, 0]  # [m]
    sigma2 = torch.as_tensor(noise, dtype=x.dtype, device=x.device) + jitter
    alpha = cg_solve_implicit(
        lambda v, fc, s2: ski_matvec_toeplitz(idx, w, fc, s2, v), y,
        (first_col, sigma2), tol=cg_tol, max_iters=4 * n, stats=stats)
    # Toeplitz eigenvalues ≈ the circulant embedding's spectrum: the top m
    eig = torch.sort(torch.fft.rfft(_circulant(first_col)).real).values[-m:]
    scaled = torch.clamp_min(eig * (n / m), 0.0)
    logdet = torch.sum(torch.log(scaled + sigma2))
    return -0.5 * torch.sum(y * alpha) - 0.5 * logdet - 0.5 * n * LOG_2PI


def ski_mll(kernel, x, y, grid, noise, jitter: float, cg_tol: float = 1e-6,
            stats: Optional[dict] = None):
    """SKI log marginal likelihood: a CG solve against the structured
    matvec and the eigenvalue-scaled log-det (the reference's SKI
    strategy). ``stats`` receives the CG iteration counts."""
    n = x.shape[0]
    state = ski_factor(kernel, x, grid)
    sigma2 = torch.as_tensor(noise, dtype=x.dtype, device=x.device) + jitter
    alpha = cg_solve_implicit(
        lambda v, K, s2: ski_matvec(state._replace(K_mm=K), s2, v), y,
        (state.K_mm, sigma2), tol=cg_tol, max_iters=4 * n, stats=stats)
    return (-0.5 * torch.sum(y * alpha)
            - 0.5 * ski_logdet_approx(state, n, sigma2)
            - 0.5 * n * LOG_2PI)
