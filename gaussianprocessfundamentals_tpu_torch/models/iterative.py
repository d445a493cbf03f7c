"""Iterative (factorisation-free) exact-GP posterior: the large-n serving path.

Counterpart of the posterior half of
``gaussianprocessfundamentals_tpu/models/iterative.py``:
``build_preconditioner`` (``:64``), ``apply_P_inv`` (``:165``),
``iterative_posterior_mean`` (``:767``), ``iterative_posterior`` (``:838``)
and the chunked route ``iterative_posterior_chunked`` (``:926``) with its
setup and chunk steps (``:886``, ``:908``). K is never formed: every Kₙ·V
goes through :func:`..ops.cuda_gram.fused_matvec_for`, the CUDA kernel on a
card and the plain row-panel version on the CPU.

Numerics that differ from the JAX package, because the H100 has native
float64 and fast batched QR:

* the thin QR of the preconditioner factor is plain ``torch.linalg.qr`` at
  every n (the JAX package's TSQR only worked around batched XLA:TPU QR);
* the small [m, m] SVD is ``torch.linalg.svd`` in float64, in place of the
  float32 one-sided Jacobi SVD, keeping small singular values at least as
  accurate;
* the variance's two column dots accumulate in float64, in place of the
  double-float32 arithmetic.
"""
from __future__ import annotations

import functools
import warnings
from typing import Optional

import torch

from gaussianprocessfundamentals_tpu_torch.linalg.mbcg import mbcg
from gaussianprocessfundamentals_tpu_torch.linalg.pivchol import (
    partial_pivoted_cholesky,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
    fused_matvec_cross_for,
    fused_matvec_for,
)


def build_preconditioner(kernel, x: torch.Tensor, m: int, noise):
    """Rank-m pivoted-Cholesky preconditioner P = σ²I + AAᵀ in its
    float32-sound applied form. Returns ``(P_inv, W_b, sv, d_rng, log_P)``.

    A = Q·Rr (thin QR, one Newton orthonormalisation pass), Rr = Ur·diag(sv)·
    Vᵀ, W = Q·Ur (two more Newton passes), and

        P⁻¹V = (V − W(WᵀV))/σ² + W·diag(1/(sv²+σ²))·WᵀV

    with the complement projection applied twice ("twice is enough"), so
    the cancellation happens before the 1/σ² amplification. A Q that is not
    close to orthonormal (‖QᵀQ − I‖ ≥ 0.01) degrades P to σ²I: CG slows but
    stays correct.
    """
    n = x.shape[0]
    dt, dev = x.dtype, x.device
    noise = torch.as_tensor(noise, dtype=dt, device=dev)
    eye = torch.eye(m, dtype=dt, device=dev)

    A = partial_pivoted_cholesky(kernel, x, m)
    A = torch.where(torch.isfinite(A).all(), A, torch.zeros_like(A))
    Q, Rr = torch.linalg.qr(A)
    QtQ = Q.T @ Q
    # soundness guard: a garbage Q would poison every preconditioned solve
    # with plausible-looking numbers
    qr_ok = torch.max(torch.abs(QtQ - eye)) < 0.01
    Q = torch.where(qr_ok, Q, torch.zeros_like(Q))
    Rr = torch.where(qr_ok, Rr, torch.zeros_like(Rr))
    Q = Q @ (1.5 * eye - 0.5 * QtQ)
    Ur, sv, _ = torch.linalg.svd(Rr.double())
    Ur, sv = Ur.to(dt), sv.to(dt)
    # sv² ≤ 1e-3·σ² adds ≤ 0.1% to the range coefficient: drop those
    # directions (their basis columns are unresolved) to the complement's
    # exact 1/σ²
    keep = sv * sv > 1e-3 * noise
    sv = torch.where(keep, sv, torch.zeros_like(sv))
    Ur = Ur * keep[None, :].to(dt)
    W_b = Q @ Ur
    # the projector term amplifies any ‖WᵀW − I‖ by 1/σ²
    for _ in range(2):
        W_b = W_b @ (1.5 * eye - 0.5 * (W_b.T @ W_b))
    d_rng = 1.0 / (sv * sv + noise)
    P_inv = functools.partial(apply_P_inv, W_b, d_rng, noise)
    log_P = (n - m) * torch.log(noise) + torch.sum(torch.log(sv * sv + noise))
    return P_inv, W_b, sv, d_rng, log_P


def apply_P_inv(W_b, d_rng, noise, V):
    """Projector-form P⁻¹V from the basis W_b and range coefficients
    d_rng = 1/(sv²+σ²), with the twice-applied complement projection."""
    vec = V.ndim == 1
    Vm = V[:, None] if vec else V
    c = W_b.T @ Vm
    comp = Vm - W_b @ c
    c2 = W_b.T @ comp
    comp = (comp - W_b @ c2) / noise
    out = comp + W_b @ (d_rng[:, None] * c)
    return out[:, 0] if vec else out


def _posterior_precond(kernel, x, noise, precond_m):
    if precond_m <= 0:
        return None
    P_inv, _, _, _, _ = build_preconditioner(
        kernel, x, min(precond_m, x.shape[0]), noise
    )
    return P_inv


def _posterior_matvec(kernel, x, noise):
    """Kₙ·V = (K + σ²I)·V through K1 (or its plain version on the CPU)."""
    kmv = fused_matvec_for(kernel, x)
    return lambda V: kmv(V) + noise * V


def _true_rel_resid(KnX, B) -> torch.Tensor:
    """‖Kₙx − b‖/‖b‖ per column, from a product already computed (the CG
    recurrence's own residual drifts below the attainable one)."""
    b = torch.linalg.norm(B, dim=0)
    r = torch.linalg.norm(KnX - B, dim=0)
    return r / torch.where(b > 0, b, torch.ones_like(b))


@torch.no_grad()
def iterative_posterior_mean(
    kernel, x, y, x_test, noise, max_iters: int = 200, tol: float = 1e-8,
    precond_m: int = 128,
):
    """μ* = K(x_test, x)·Kₙ⁻¹y with a preconditioned CG solve."""
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    res = mbcg(_posterior_matvec(kernel, x, noise), y[:, None],
               max_iters=max_iters, tol=tol,
               precond=_posterior_precond(kernel, x, noise, precond_m))
    return fused_matvec_cross_for(kernel, x_test, x)(res.solves[:, 0])


def _variance_energy_f64(kernel, x_test, K_s, V, KnV):
    """Marginal variances from approximate solves V ≈ Kₙ⁻¹K_s in the energy
    (Galerkin) form var = k_ss − 2·k_sᵀv + vᵀKₙv, with both column dots
    accumulated in float64. The error is second order in the solve residual
    and can only overestimate the variance.

    Returns ``(var, floor)``: ``floor`` is the resolution limit set by the
    rounding of the float32 kernel entries themselves,
    ~4·eps·(k_ss + 2·Σ|k_s·v| + Σ|v·Kₙv|); no algorithm consuming those
    entries resolves a variance below it.
    """
    f64 = torch.float64
    t1 = torch.sum(K_s.to(f64) * V.to(f64), dim=0)
    t2 = torch.sum(V.to(f64) * KnV.to(f64), dim=0)
    k_ss = kernel.diag(x_test).to(f64)
    var = torch.clamp_min(k_ss - 2.0 * t1 + t2, 0.0)
    eps = 4.0 * torch.finfo(K_s.dtype).eps
    floor = eps * (
        k_ss
        + 2.0 * torch.sum(torch.abs(K_s * V), dim=0).to(f64)
        + torch.sum(torch.abs(V * KnV), dim=0).to(f64)
    )
    return var.to(K_s.dtype), floor.to(K_s.dtype)


@torch.no_grad()
def iterative_posterior(
    kernel, x, y, x_test, noise, max_iters: int = 200, tol: float = 1e-8,
    precond_m: int = 128,
):
    """(μ*, var*) from one mBCG solve against [y | K_s]; variances in the
    energy form at the price of one extra Kₙ·V."""
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    matvec = _posterior_matvec(kernel, x, noise)
    K_s = kernel.gram(x, x_test)  # [n, t]
    B = torch.cat([y[:, None], K_s], dim=1)
    res = mbcg(matvec, B, max_iters=max_iters, tol=tol,
               precond=_posterior_precond(kernel, x, noise, precond_m),
               early_exit=True)
    alpha = res.solves[:, 0]
    V = res.solves[:, 1:]
    var, _ = _variance_energy_f64(kernel, x_test, K_s, V, matvec(V))
    return K_s.T @ alpha, var


def _posterior_setup(kernel, x, y, noise, m, max_iters, tol):
    """Preconditioner build + the single y-solve. ``m == 0`` degrades to
    P = σ²I (a zero basis)."""
    n = x.shape[0]
    if m > 0:
        P_inv, W_b, _, d_rng, _ = build_preconditioner(kernel, x, m, noise)
    else:
        W_b = torch.zeros((n, 1), dtype=x.dtype, device=x.device)
        d_rng = torch.zeros((1,), dtype=x.dtype, device=x.device)
        P_inv = functools.partial(apply_P_inv, W_b, d_rng, noise)
    matvec = _posterior_matvec(kernel, x, noise)
    B = y[:, None]
    res = mbcg(matvec, B, max_iters=max_iters, tol=tol, precond=P_inv,
               early_exit=True)
    alpha = res.solves
    return (alpha[:, 0], W_b, d_rng, res.iters,
            _true_rel_resid(matvec(alpha), B))


def _posterior_chunk(kernel, x, alpha, xt, noise, W_b, d_rng, max_iters, tol):
    """One test-point chunk, reusing the prebuilt basis and y-solve."""
    matvec = _posterior_matvec(kernel, x, noise)
    K_s = kernel.gram(x, xt)  # [n, c]
    res = mbcg(matvec, K_s, max_iters=max_iters, tol=tol,
               precond=functools.partial(apply_P_inv, W_b, d_rng, noise),
               early_exit=True)
    V = res.solves
    KnV = matvec(V)
    var, floor = _variance_energy_f64(kernel, xt, K_s, V, KnV)
    return K_s.T @ alpha, var, floor, res.iters, _true_rel_resid(KnV, K_s)


@torch.no_grad()
def iterative_posterior_chunked(
    kernel, x, y, x_test, noise, max_iters: int = 100, tol: float = 1e-6,
    precond_m: int = 128, chunk: int = 256, stats: Optional[dict] = None,
):
    """(μ*, var*) for large n·t: the preconditioner and the y-solve are
    built once, then test points are solved in chunks of ``chunk`` columns
    (the last chunk padded to full width by repeating its last point). CG
    per column is independent, so chunking changes no result; it bounds the
    CG state at [n, chunk].

    ``stats``, when given, receives per solve (the y-solve first, then one
    entry per chunk) the CG iterations (``"iters"``) and the largest true
    relative residual ‖Kₙx − b‖/‖b‖ over its columns (``"rel_resid"``).
    That costs one extra Kₙ·α product; the chunks reuse the variance's
    Kₙ·V.
    """
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    m = min(precond_m, x.shape[0]) if precond_m > 0 else 0
    alpha, W_b, d_rng, it, rel = _posterior_setup(
        kernel, x, y, noise, m, max_iters, tol
    )
    iters, rels = [it], [rel.max()]
    t = x_test.shape[0]
    cw = min(chunk, t)
    mus, vars_, floors = [], [], []
    for c0 in range(0, t, cw):
        xt = x_test[c0:c0 + cw]
        pad = cw - xt.shape[0]
        if pad:
            xt = torch.cat([xt, xt[-1:].expand((pad,) + xt.shape[1:])])
        mu_c, var_c, floor_c, it, rel = _posterior_chunk(
            kernel, x, alpha, xt, noise, W_b, d_rng, max_iters, tol
        )
        keep = cw - pad
        mus.append(mu_c[:keep])
        vars_.append(var_c[:keep])
        floors.append(floor_c[:keep])
        iters.append(it)
        rels.append(rel[:keep].max())
    var = torch.cat(vars_)
    floor = torch.cat(floors)
    n_floored = int(torch.sum(var <= floor))
    if n_floored:
        # the true variance sits at or below the float32 kernel-entry
        # resolution: say so rather than report noise as a band
        warnings.warn(
            f"posterior variances at {n_floored}/{t} test points are at or "
            "below the f32 kernel-entry resolution floor "
            f"(~{float(torch.max(floor)):.1e}); reported sds there are "
            "resolution-limited (training density is extreme relative to "
            "f32 precision).",
            stacklevel=2,
        )
    if stats is not None:
        stats["iters"] = iters
        stats["rel_resid"] = torch.stack(rels).tolist()
    return torch.cat(mus), var
