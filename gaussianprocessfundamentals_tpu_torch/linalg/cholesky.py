"""Cholesky-based log marginal likelihood and posterior for the dense route.

Counterpart of ``gaussianprocessfundamentals_tpu/linalg/cholesky.py``
(``:28-185``): the dense MLL with its closed-form gradient, the dense
posterior below the iterative threshold, and the small-n oracle on the
card. ``torch.linalg`` does the work. ``y`` is ``[..., n]``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

LOG_2PI = 1.8378770664093453


def add_diag(K: torch.Tensor, v) -> torch.Tensor:
    """K + v·I along the trailing square dims (v scalar or [...])."""
    v = torch.as_tensor(v, dtype=K.dtype, device=K.device)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return K + v[..., None, None] * eye if v.ndim else K + v * eye


def cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorisation fails (as
    ``jnp.linalg.cholesky``); no host read, differentiable."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def effective_jitter(K: torch.Tensor, jitter, eps_factor: float = 100.0):
    """Dtype-aware jitter floor: max(jitter, eps_factor·eps·mean diag(K)).

    A fixed 1e-8 assumes float64; a float32 Gram carries O(eps·‖K‖)
    rounding, under which 1e-8 underflows and the factorisation fails."""
    return effective_jitter_of_diag(torch.diagonal(K, dim1=-2, dim2=-1),
                                    jitter, eps_factor)


def effective_jitter_of_diag(diag_K: torch.Tensor, jitter,
                             eps_factor: float = 100.0):
    """:func:`effective_jitter` from diag(K) alone ([..., n]): what a Gram
    Gram kernel that adds the noise in its own pass needs before K exists."""
    eps = torch.finfo(diag_K.dtype).eps
    return torch.clamp_min(eps_factor * eps * diag_K.mean(dim=-1).detach(),
                           jitter)


def noised(K: torch.Tensor, noise, jitter: float) -> torch.Tensor:
    """K + (σ² + jitter)·I, with the jitter floored by
    :func:`effective_jitter`."""
    noise = torch.as_tensor(noise, dtype=K.dtype, device=K.device)
    return add_diag(K, noise + effective_jitter(K, jitter))


class CholState(NamedTuple):
    L: torch.Tensor  # lower Cholesky factor of K + (σ²+jitter)I
    alpha: torch.Tensor  # (K+σ²I)⁻¹ y
    logdet: torch.Tensor  # log|K+σ²I|


def factor(K: torch.Tensor, y: torch.Tensor, noise, jitter: float) -> CholState:
    return factor_noised(noised(K, noise, jitter), y)


def factor_noised(Kn: torch.Tensor, y: torch.Tensor) -> CholState:
    """:func:`factor` of a matrix that already carries its noise and jitter
    (Kₙ = K + (σ² + jitter)·I, as the dense Gram kernels build it)."""
    L = torch.linalg.cholesky(Kn)
    z = torch.linalg.solve_triangular(L, y[..., None], upper=False)
    alpha = torch.linalg.solve_triangular(L.mT, z, upper=True)[..., 0]
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(dim=-1)
    return CholState(L, alpha, logdet)


def mll_from_state(state: CholState, y: torch.Tensor) -> torch.Tensor:
    """Log marginal likelihood −½yᵀα − ½log|K| − (n/2)·log 2π."""
    n = y.shape[-1]
    return (-0.5 * torch.sum(y * state.alpha, dim=-1) - 0.5 * state.logdet
            - 0.5 * n * LOG_2PI)


_TRI_LEAF = 128  # rows below which tri_inverse solves instead of recursing


def tri_inverse(L: torch.Tensor) -> torch.Tensor:
    """L⁻¹ of lower-triangular L [..., n, n] by 2 × 2 block recursion:
    inv([[A, 0], [B, C]]) = [[A⁻¹, 0], [−C⁻¹·B·A⁻¹, C⁻¹]], the two diagonal
    blocks as one batched call when their sizes match, and triangular
    solves only on leaves of at most ``_TRI_LEAF`` rows. The work is
    matrix products, where ``torch.cholesky_inverse`` runs batched
    triangular solves on the card (``chip_smoke.py`` phase 32 times
    both)."""
    n = L.shape[-1]
    if n <= _TRI_LEAF:
        eye = torch.eye(n, dtype=L.dtype, device=L.device).expand_as(L)
        return torch.linalg.solve_triangular(L, eye, upper=False)
    h = n // 2
    A, B, C = L[..., :h, :h], L[..., h:, :h], L[..., h:, h:]
    if n == 2 * h:
        Ai, Ci = tri_inverse(torch.stack([A, C])).unbind(0)
    else:
        Ai, Ci = tri_inverse(A), tri_inverse(C)
    top = torch.cat([Ai, torch.zeros_like(L[..., :h, h:])], dim=-1)
    return torch.cat([top, torch.cat([-(Ci @ (B @ Ai)), Ci], dim=-1)],
                     dim=-2)


class _MLLCore(torch.autograd.Function):
    """MLL of N(y | 0, Kₙ) with the closed-form backward

        ∂mll/∂Kₙ = ½(ααᵀ − Kₙ⁻¹),   ∂mll/∂y = −α,

    with Kₙ⁻¹ = L⁻ᵀL⁻¹ from :func:`tri_inverse` instead of differentiating
    through the factorisation. A factorisation that fails (Kₙ not positive
    definite at this precision) gives NaN, as the JAX package's does, so
    ``fit`` can escalate the jitter; it is checked on the device, without a
    host read.
    """

    @staticmethod
    def forward(ctx, Kn, y):
        L, info = torch.linalg.cholesky_ex(Kn)
        alpha = torch.cholesky_solve(y[..., None], L)[..., 0]
        logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        n = y.shape[-1]
        out = -0.5 * torch.sum(y * alpha, dim=-1) - 0.5 * logdet - 0.5 * n * LOG_2PI
        out = torch.where(info == 0, out, torch.full_like(out, float("nan")))
        ctx.save_for_backward(L, alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        L, alpha = ctx.saved_tensors
        L_inv = tri_inverse(L)
        Kn_inv = L_inv.mT @ L_inv
        aa = alpha[..., :, None] * alpha[..., None, :]
        dKn = 0.5 * (aa - Kn_inv) * g[..., None, None]
        dy = -alpha * g[..., None]
        return dKn, dy


def mll(K: torch.Tensor, y: torch.Tensor, noise, jitter: float) -> torch.Tensor:
    """Log marginal likelihood of y under K + (σ² + jitter)·I."""
    return mll_noised(noised(K, noise, jitter), y)


def mll_noised(Kn: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Log marginal likelihood of y under a matrix that already carries its
    noise and jitter."""
    return _MLLCore.apply(Kn, y)


def nll(K: torch.Tensor, y: torch.Tensor, noise, jitter: float) -> torch.Tensor:
    """Negative log marginal likelihood, the fitting objective."""
    return -mll(K, y, noise, jitter)


def posterior_mean(state: CholState, K_s: torch.Tensor) -> torch.Tensor:
    """μ* = K_sᵀα; K_s: [..., n_train, n_test] → [..., n_test]."""
    return torch.einsum("...nt,...n->...t", K_s, state.alpha)


def posterior_cov(state: CholState, K_s: torch.Tensor,
                  K_ss: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Σ* = K_ss − vᵀv with v = L⁻¹K_s, plus jitter·I when given."""
    v = torch.linalg.solve_triangular(state.L, K_s, upper=False)
    cov = K_ss - v.mT @ v
    return add_diag(cov, jitter) if jitter else cov


def posterior_var(state: CholState, K_s: torch.Tensor,
                  K_ss_diag: torch.Tensor) -> torch.Tensor:
    """Marginal posterior variances without the full test covariance."""
    v = torch.linalg.solve_triangular(state.L, K_s, upper=False)
    return K_ss_diag - torch.sum(v * v, dim=-2)
