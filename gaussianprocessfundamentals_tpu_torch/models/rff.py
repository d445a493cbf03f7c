"""Random Fourier features and pathwise (Matheron) posterior sampling.

Counterpart of ``gaussianprocessfundamentals_tpu/models/rff.py``:
``RFFState`` (``:32``), ``rff_init`` (``:38-57``), ``rff_features``
(``:60-65``), ``rff_prior_sample`` (``:68-71``) and
``pathwise_posterior_samples`` (``:74-107``), after Wilson et al. (2020):

* a stationary prior is ≈ φ(x)ᵀw with D random features (Bochner: the SE
  spectral density is Gaussian, the Matérn-ν one a multivariate t with 2ν
  degrees of freedom), so prior draws at any points cost O(D·t);
* a posterior draw is the prior draw plus K(·, X)(K + σ²I)⁻¹(y − f(X) − ε),
  one batched CG solve for every sample path.

Random draws come from an explicit ``torch.Generator`` in a fixed order
(frequencies, Gamma variates for a Matérn, phases, then the weights and the
noise), and :func:`pathwise_from_draws` takes them as arguments, so a test
can hand both packages the same numbers. torch's Gamma sampler takes no
generator; :func:`gamma_marsaglia_tsang` draws the Matérn's χ² variates from
the generator's normals and uniforms.

Grams: ``K + (σ² + jitter)·I`` and ``K(X, X*)`` come from
:func:`..ops.cuda_dense_gram.dense_gram_for` (K5 for SE leaves, K6 for
Matérn leaves at d = 1 on a card); the product inside CG is
``torch.matmul``, as the JAX package's is a plain product.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gaussianprocessfundamentals_tpu_torch.kernels.leaves import (
    Matern32Kernel,
    Matern52Kernel,
    SquaredExponentialKernel,
)
from gaussianprocessfundamentals_tpu_torch.linalg.mbcg import mbcg
from gaussianprocessfundamentals_tpu_torch.ops.cuda_dense_gram import (
    dense_gram_for,
)


class RFFState(NamedTuple):
    omega: torch.Tensor  # [D, d] spectral frequencies
    phase: torch.Tensor  # [D]
    scale: torch.Tensor  # sqrt(2·variance/D)


def _draw(sample, shape, generator, like: torch.Tensor) -> torch.Tensor:
    """``sample`` (``torch.randn`` or ``torch.rand``) of ``shape`` in
    ``like``'s dtype, drawn on the generator's device (``like``'s without
    one) and moved to ``like``'s."""
    dev = generator.device if generator is not None else like.device
    return sample(shape, generator=generator, dtype=like.dtype,
                  device=dev).to(like.device)


def gamma_marsaglia_tsang(alpha: float, shape, generator, like: torch.Tensor):
    """Gamma(α, 1) draws for α ≥ 1 by Marsaglia and Tsang (2000): with
    d = α − 1/3, c = 1/√(9d), a normal x and a uniform u, v = (1 + c·x)³ is
    accepted when v > 0 and log u < x²/2 + d − d·v + d·log v, giving d·v.
    Each round draws one normal and one uniform for every entry still open
    (a round reads the open count to the host)."""
    if alpha < 1.0:
        raise ValueError(f"gamma_marsaglia_tsang needs alpha >= 1, got {alpha}")
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    numel = math.prod(shape)
    out = torch.empty(numel, dtype=like.dtype, device=like.device)
    todo = torch.arange(numel, device=like.device)
    while todo.numel():
        xn = _draw(torch.randn, (todo.numel(),), generator, like)
        u = _draw(torch.rand, (todo.numel(),), generator, like)
        v = (1.0 + c * xn) ** 3
        log_v = torch.log(torch.clamp_min(v, torch.finfo(v.dtype).tiny))
        ok = (v > 0) & (torch.log(u) < 0.5 * xn * xn + d - d * v + d * log_v)
        out[todo[ok]] = (d * v)[ok]
        todo = todo[~ok]
    return out.reshape(shape)


def rff_init(kernel, dim: int, num_features: int, generator=None) -> RFFState:
    """Spectral frequencies for an SE, Matérn-3/2 or Matérn-5/2 leaf at its
    installed hyperparameters (``variance`` 1 for an unscaled leaf):
    ω = N(0, I)/ℓ, times √(2ν/χ²_{2ν}) for a Matérn-ν; phases U(0, 2π)."""
    if not isinstance(kernel, (SquaredExponentialKernel, Matern32Kernel,
                               Matern52Kernel)):
        raise NotImplementedError(
            f"RFF supports SE/Matérn kernels, got {type(kernel).__name__}")
    ls = kernel.lengthscale
    omega = _draw(torch.randn, (num_features, dim), generator, ls) / ls
    if not isinstance(kernel, SquaredExponentialKernel):
        nu = 1.5 if isinstance(kernel, Matern32Kernel) else 2.5
        chi2 = 2.0 * gamma_marsaglia_tsang(nu, (num_features, 1), generator,
                                           ls)
        omega = omega * torch.sqrt(2.0 * nu / chi2)
    phase = 2.0 * math.pi * _draw(torch.rand, (num_features,), generator, ls)
    variance = kernel.variance if kernel.scaled else torch.ones_like(ls)
    scale = torch.sqrt(2.0 * variance / num_features)
    return RFFState(omega, phase, scale)


def rff_features(state: RFFState, x: torch.Tensor) -> torch.Tensor:
    """φ(x): [n, D], with k(x, x') ≈ φ(x)ᵀφ(x')."""
    return state.scale * torch.cos(x @ state.omega.T + state.phase)


def rff_prior_sample(state: RFFState, x: torch.Tensor, generator=None,
                     num_samples: int = 1) -> torch.Tensor:
    """f(x) ≈ φ(x)·w, w ~ N(0, I_D): [num_samples, n]."""
    w = _draw(torch.randn, (state.omega.shape[0], num_samples), generator, x)
    return (rff_features(state, x) @ w).T


@torch.no_grad()
def pathwise_from_draws(kernel, x, y, x_test, noise, state: RFFState, w,
                        eps, max_iters: int = 200, tol: float = 1e-8,
                        jitter: float = 1e-8) -> torch.Tensor:
    """Matheron-rule draws [s, t] at x_test from given randoms: the RFF
    state, the prior weights w [D, s] and standard-normal noise draws
    eps [s, n] (scaled by √σ² here). The CG runs ``max_iters`` iterations
    at ``tol`` against K + (σ² + jitter)·I, built in one pass."""
    n = x.shape[0]
    f_prior = (rff_features(state, torch.cat([x, x_test], dim=0)) @ w).T
    f_X, f_T = f_prior[:, :n], f_prior[:, n:]
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    resid = y[None, :] - f_X - torch.sqrt(noise) * eps  # [s, n]
    Kn = dense_gram_for(kernel, x, x, noise + jitter)
    sol = mbcg(lambda V: Kn @ V, resid.T, max_iters=max_iters,
               tol=tol).solves  # [n, s]
    K_s = dense_gram_for(kernel, x, x_test)  # [n, t]
    return f_T + (K_s.T @ sol).T


def pathwise_posterior_samples(kernel, x, y, x_test, noise, generator=None,
                               num_samples: int = 8,
                               num_features: int = 1024,
                               max_iters: int = 200, tol: float = 1e-8,
                               jitter: float = 1e-8) -> torch.Tensor:
    """Posterior function draws at x_test: [num_samples, t], at the
    kernel's installed hyperparameters. Draws the RFF state, the weights
    and the noise from ``generator`` (in that order), then
    :func:`pathwise_from_draws`: one batched CG solve against K + σ²I for
    all paths, no factorisation of the t×t test covariance."""
    state = rff_init(kernel, x.shape[-1], num_features, generator)
    w = _draw(torch.randn, (num_features, num_samples), generator, x)
    eps = _draw(torch.randn, (num_samples, x.shape[0]), generator, x)
    return pathwise_from_draws(kernel, x, y, x_test, noise, state, w, eps,
                               max_iters, tol, jitter)
