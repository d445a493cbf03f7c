"""Nyström low-rank approximation: Woodbury solves and the determinant-lemma
log-determinant.

Counterpart of ``gaussianprocessfundamentals_tpu/linalg/nystroem.py``:
``NystroemState`` (``:29``), ``nystroem_factor`` (``:37``),
``woodbury_solve`` (``:72``), ``nystroem_logdet`` (``:86``),
``nystroem_mll`` (``:94``), ``nystroem_nll`` (``:126``) and
``nystroem_posterior`` (``:130``). K̂ = K_nm·K_mm⁻¹·K_nmᵀ for inducing
inputs z [m, d]; everything goes through the m×m core factor, so nothing
n×n is formed.

Grams: the objectives (:func:`nystroem_mll`, and through it the SKC bound
and ``fit(approximation=…)``) differentiate ``kernel.gram``, also with
respect to z. :func:`nystroem_posterior` is forward-only and builds K_nm,
K_mm and K_tm with :func:`..ops.cuda_dense_gram.dense_gram_for`, which on
a card launches K5 (SE) or K6 (Matérn at d = 1), at the kernel's
installed hyperparameters.

Precision: the Grams keep x's dtype (float32 from K5/K6 on a card), and
the jitter level is picked from K_mm at that precision, as the JAX package
picks it; the factorisations, solves and sums then run in float64 and the
results come back in x's dtype (for float64 inputs this is the JAX
package's arithmetic). In float32 the algebra fails at the sizes the
approximations are for: at N = 100,000 and m = 2,048 the card's float32
Cholesky of σ²I + AᵀA (κ ~ n·σ_f²/σ²) does not factor, so the objective
and the posterior are NaN, and where it factors (the CPU, or smaller n)
var* = k_diag − (a quantity ≈ k_diag) keeps no digit of a variance ~1e-6
of k_diag (``tools/nystroem_precision.py`` measures it).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import (
    LOG_2PI,
    add_diag,
    cholesky_or_nan,
    effective_jitter,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_dense_gram import (
    dense_gram_for,
)

_F64 = torch.float64


class NystroemState(NamedTuple):
    K_nm: torch.Tensor  # [n, m] cross-covariance
    L_mm: torch.Tensor  # chol(K_mm + jitter·I)
    A: torch.Tensor  # K_nm·L_mm⁻ᵀ ("Φᵀ", [n, m]): K̂ = A·Aᵀ
    L_core: torch.Tensor  # chol(σ²I_m + AᵀA)
    noise: torch.Tensor


def _factors(A: torch.Tensor) -> torch.Tensor:
    """A device bool: A's Cholesky succeeds with a finite factor."""
    L, info = torch.linalg.cholesky_ex(A)
    return (info == 0) & torch.isfinite(L).all()


def nystroem_jitter(K_mm: torch.Tensor, jitter) -> torch.Tensor:
    """The jitter level of the factor of K_mm, a device scalar: the
    dtype-aware floor of :func:`effective_jitter`, raised 100× or 10⁴×
    where K_mm + jitter·I does not factor at K_mm's own precision (fitted
    inducing points can collide, which leaves K_mm singular in float32).
    Probe factorisations of a detached K_mm pick it, so the one
    differentiable Cholesky that follows sends no NaN gradient from a
    failed probe into an ``optimize_inducing`` fit."""
    base = effective_jitter(K_mm, jitter)
    K_sg = K_mm.detach()
    return torch.where(
        _factors(add_diag(K_sg, base)), base,
        torch.where(_factors(add_diag(K_sg, 100.0 * base)), 100.0 * base,
                    1e4 * base))


def _f64(t) -> torch.Tensor:
    """t in float64, differentiably (a Python number on the CPU)."""
    return t.to(_F64) if torch.is_tensor(t) else torch.tensor(t, dtype=_F64)


def _factor(K_nm, K_mm, noise, jit) -> NystroemState:
    K_nm, K_mm = K_nm.to(_F64), K_mm.to(_F64)
    L_mm = cholesky_or_nan(add_diag(K_mm, jit.to(_F64)))
    A = torch.linalg.solve_triangular(L_mm.mT, K_nm, upper=True, left=False)
    noise = _f64(noise).to(K_nm.device)
    L_core = cholesky_or_nan(add_diag(A.T @ A, noise))
    return NystroemState(K_nm, L_mm, A, L_core, noise)


def nystroem_factor(kernel, x, z, noise, jitter: float) -> NystroemState:
    """Factor the rank-m approximation defined by the inducing inputs z
    [m, d]: the Grams from ``kernel.gram`` in x's dtype (differentiable,
    also with respect to z), the jitter level from K_mm at that precision
    (:func:`nystroem_jitter`), the factor in float64 (every tensor of the
    state is float64)."""
    K_nm = kernel.gram(x, z)
    K_mm = kernel.gram(z, z)
    return _factor(K_nm, K_mm, noise, nystroem_jitter(K_mm, jitter))


def _core_solve(state: NystroemState, B: torch.Tensor) -> torch.Tensor:
    """(σ²I + AᵀA)⁻¹B through L_core; B [m, k]."""
    w = torch.linalg.solve_triangular(state.L_core, B, upper=False)
    return torch.linalg.solve_triangular(state.L_core.mT, w, upper=True)


def woodbury_solve(state: NystroemState, b: torch.Tensor) -> torch.Tensor:
    """(K̂ + σ²I)⁻¹b = b/σ² − A(σ²I + AᵀA)⁻¹Aᵀb/σ²; b [n] or [n, k],
    the result in b's dtype."""
    vec = b.ndim == 1
    b64 = (b[:, None] if vec else b).to(_F64)
    w = _core_solve(state, state.A.T @ b64)
    out = ((b64 - state.A @ w) / state.noise).to(b.dtype)
    return out[:, 0] if vec else out


def nystroem_logdet(state: NystroemState, n: int) -> torch.Tensor:
    """log|K̂ + σ²I| = (n−m)·log σ² + log|σ²I_m + AᵀA| (the matrix
    determinant lemma), in float64."""
    m = state.L_core.shape[0]
    core_logdet = 2.0 * torch.sum(torch.log(torch.diagonal(state.L_core)))
    return (n - m) * torch.log(state.noise) + core_logdet


def nystroem_mll(kernel, x, y, z, noise, jitter: float,
                 titsias_correction: bool = False, diag_fn=None):
    """Approximate log marginal likelihood under K̂ = K_nm K_mm⁻¹ K_nmᵀ,
    in x's dtype.

    With ``titsias_correction`` it is the SKC/Titsias lower bound
    ll − tr(K − K̂)/(2σ²), with the actual noise σ² (the Titsias 2009 form),
    not the jitter. tr(K) comes from ``diag_fn(x)`` (default
    ``kernel.diag``), so the bound costs O(nm²), never O(n²).
    """
    n = x.shape[0]
    state = nystroem_factor(kernel, x, z, noise, jitter)
    y64 = y.to(_F64)
    alpha = woodbury_solve(state, y64)
    ll = (-0.5 * torch.sum(y64 * alpha) - 0.5 * nystroem_logdet(state, n)
          - 0.5 * n * LOG_2PI)
    if titsias_correction:
        diag = diag_fn(x) if diag_fn is not None else kernel.diag(x)
        trace_K = torch.sum(diag.to(_F64))
        trace_Khat = torch.sum(state.A * state.A)
        ll = ll - (trace_K - trace_Khat) / (2.0 * state.noise)
    return ll.to(x.dtype)


def nystroem_nll(kernel, x, y, z, noise, jitter, **kw):
    return -nystroem_mll(kernel, x, y, z, noise, jitter, **kw)


@torch.no_grad()
def nystroem_posterior(kernel, x, y, z, x_test, noise, jitter: float):
    """Projected-process posterior moments (μ*, var*) at x_test in O(nm²)
    + O(tm²), at the kernel's installed hyperparameters, in x's dtype:

        μ* = K_tm L_mm⁻ᵀ (σ²I + AᵀA)⁻¹ Aᵀ y,
        var* = k_diag − diag(K_tm K_mm⁻¹ K_tmᵀ) + σ²·‖L_core⁻¹ L_mm⁻¹ k_tm‖².

    K_nm, K_mm and K_tm come from :func:`dense_gram_for` (K5 or K6 on a
    card for the leaves they cover); the algebra runs in float64."""
    K_nm = dense_gram_for(kernel, x, z)
    K_mm = dense_gram_for(kernel, z, z)
    K_tm = dense_gram_for(kernel, x_test, z).to(_F64)
    state = _factor(K_nm, K_mm, noise, nystroem_jitter(K_mm, jitter))
    B = torch.linalg.solve_triangular(state.L_mm.mT, K_tm, upper=True,
                                      left=False)  # [t, m]
    w2 = _core_solve(state, (state.A.T @ y.to(_F64))[:, None])[:, 0]
    mu = B @ w2
    C = torch.linalg.solve_triangular(state.L_core, B.T, upper=False)  # [m, t]
    k_diag = kernel.diag(x_test).to(_F64)
    var = k_diag - torch.sum(B * B, dim=-1) + state.noise * torch.sum(C * C, dim=0)
    return mu.to(x.dtype), torch.clamp_min(var, 0.0).to(x.dtype)
