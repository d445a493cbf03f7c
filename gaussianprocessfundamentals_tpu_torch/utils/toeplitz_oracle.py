"""A float64 host posterior oracle for large-n checks, by Toeplitz/FFT.

Counterpart of ``gaussianprocessfundamentals_tpu/utils/toeplitz_oracle.py``
(numpy only there too). The port keeps its own copy: importing the JAX
package's module would import that package, and with it jax.

Checking the float32 card posterior at n = 50k+ against "exact float64"
needs an oracle that does not itself cost O(n³) time or O(n²) memory. On an
equispaced 1-D grid a stationary kernel's Gram matrix is symmetric
Toeplitz, so

* Kₙ·V is an FFT circulant-embedding product, O(n log n) per matvec;
* CG in float64 with a Strang circulant preconditioner converges in tens
  of iterations to ~1e-12 relative residuals (float64 has no eps·κ floor
  at these condition numbers).

The system under test (``models.iterative.iterative_posterior``) is given
the same grid but not its structure: it runs the generic Gram·V mBCG path,
so the oracle checks the code that serves arbitrary inputs.
"""
from __future__ import annotations

import numpy as np


def se_first_column(n: int, h: float, lengthscale: float) -> np.ndarray:
    """First column of the SE Gram on an equispaced grid with spacing h."""
    d = np.arange(n, dtype=np.float64) * h
    return np.exp(-0.5 * (d / lengthscale) ** 2)


def toeplitz_matvec_factory(col: np.ndarray):
    """Symmetric-Toeplitz matvec via circulant embedding: K@V for V [n, r]."""
    n = col.shape[0]
    # circulant embedding of size 2n: [c0 c1 … c_{n-1} 0 c_{n-1} … c1]
    emb = np.concatenate([col, [0.0], col[:0:-1]])
    f_emb = np.fft.rfft(emb)

    def matvec(V: np.ndarray) -> np.ndarray:
        Vp = np.zeros((2 * n,) + V.shape[1:], np.float64)
        Vp[:n] = V
        out = np.fft.irfft(np.fft.rfft(Vp, axis=0) * f_emb[:, None], axis=0)
        return out[:n]

    return matvec


def strang_precond_factory(col: np.ndarray, noise: float):
    """Strang circulant preconditioner P⁻¹ for Kₙ = Toeplitz(col) + σ²I:
    the central band of the Toeplitz symbol copied into a circulant,
    inverted by FFT. Clusters the spectrum at 1 for smooth decaying kernels
    (Chan & Strang 1989)."""
    n = col.shape[0]
    c = np.zeros(n, np.float64)
    half = n // 2
    c[: half + 1] = col[: half + 1]
    c[half + 1:] = col[1: n - half][::-1]
    c[0] += noise
    f_c = np.fft.rfft(c)
    # the circulant of an SPD-generating symbol has real positive
    # eigenvalues; clamp against round-off
    f_c = np.maximum(f_c.real, 1e-300)

    def apply(V: np.ndarray) -> np.ndarray:
        return np.fft.irfft(
            np.fft.rfft(V, axis=0) / f_c[:, None], axis=0, n=n
        )

    return apply


def pcg_f64(matvec, precond, B: np.ndarray, tol: float = 1e-12,
            max_iters: int = 500) -> tuple[np.ndarray, np.ndarray]:
    """Plain block PCG in float64, independent of ``linalg.mbcg``. Returns
    (X, relative residual per column)."""
    X = np.zeros_like(B)
    R = B.copy()
    Z = precond(R)
    P = Z.copy()
    rz = np.sum(R * Z, axis=0)
    b_norm = np.maximum(np.linalg.norm(B, axis=0), 1e-300)
    for _ in range(max_iters):
        AP = matvec(P)
        alpha = rz / np.sum(P * AP, axis=0)
        X += alpha * P
        R -= alpha * AP
        if np.all(np.linalg.norm(R, axis=0) / b_norm < tol):
            break
        Z = precond(R)
        rz_new = np.sum(R * Z, axis=0)
        P = Z + (rz_new / rz) * P
        rz = rz_new
    return X, np.linalg.norm(R, axis=0) / b_norm


def se_grid_posterior_oracle(
    n: int, lengthscale: float, noise: float, x_test: np.ndarray,
    y: np.ndarray, tol: float = 1e-12,
):
    """Float64 posterior moments (μ*, var*) of a unit-variance SE GP on the
    equispaced grid x_i = i/(n−1) ∈ [0, 1], marginal variances only.

    Returns (mu, var, max_rel_resid): callers assert that the oracle's own
    residual is far below the tolerance being certified.
    """
    h = 1.0 / (n - 1)
    grid = np.arange(n, dtype=np.float64) * h
    col = se_first_column(n, h, lengthscale)
    coln = col.copy()
    coln[0] += noise
    matvec = toeplitz_matvec_factory(coln)
    precond = strang_precond_factory(col, noise)

    d = grid[:, None] - np.asarray(x_test, np.float64)[None, :]
    Ks = np.exp(-0.5 * (d / lengthscale) ** 2)  # [n, t]
    B = np.concatenate([np.asarray(y, np.float64)[:, None], Ks], axis=1)
    X, rel = pcg_f64(matvec, precond, B, tol=tol)
    alpha, V = X[:, 0], X[:, 1:]
    mu = Ks.T @ alpha
    var = 1.0 - np.sum(Ks * V, axis=0)
    return mu, var, float(rel.max())
