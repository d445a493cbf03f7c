"""Sparse variational GP (SVGP): inducing inputs and the minibatch ELBO.

Counterpart of ``gaussianprocessfundamentals_tpu/models/svgp.py``:
``SVGPParams`` (``:35``), ``init_svgp_params`` (``:43``),
``_whitened_marginals`` (``:63-81``), ``svgp_elbo`` (``:84-114``),
``collapsed_elbo`` (``:117-126``), ``svgp_predict`` (``:129-140``) and
``fit_svgp`` (``:143-182``), after Titsias (2009) and Hensman et al.
(2013): continuous inducing inputs Z, q(u) = N(m, S) in whitened
coordinates with S = L·Lᵀ, and

    ELBO = (n/|batch|)·Σ_batch E_q[log N(y_i | f_i, σ²)] − KL(q‖p),

so a step costs O(b·m² + m³). The kernel's hyperparameters live in
``SVGPParams.kernel_u`` (unconstrained); each function installs their
constrained values in the kernel module, as ``fit`` does. A mean module is
held at its installed hyperparameters (the JAX package's fixed
``mean_params``).

Grams: the ELBO differentiates ``kernel.gram``; :func:`svgp_predict`, which
needs no gradient, builds K_mm (with its jitter floor on the diagonal) and
K_mx with :func:`..ops.cuda_dense_gram.dense_gram_for`: on a card K5 for SE
leaves and K6 for Matérn leaves at d = 1.

The Adam loop reads nothing to the host: minibatch indices come from a
generator on the data's device, the Cholesky returns NaN where it fails
(as ``jnp.linalg.cholesky``) instead of raising, and a step whose loss or
gradient is not finite hands Adam a zeroed gradient through ``torch.where``
(Adam still updates its moments and moves the parameters, as optax does).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from gaussianprocessfundamentals_tpu_torch.config import DEFAULT_CONFIG
from gaussianprocessfundamentals_tpu_torch.fit.transforms import (
    constrain,
    unconstrain,
)
from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import (
    LOG_2PI,
    add_diag,
    cholesky_or_nan,
    effective_jitter,
    effective_jitter_of_diag,
)
from gaussianprocessfundamentals_tpu_torch.linalg.nystroem import nystroem_mll
from gaussianprocessfundamentals_tpu_torch.means.functions import (
    MeanFunction,
    ZeroMean,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_dense_gram import (
    dense_gram_for,
)
from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

# K_mm's jitter floor in units of eps·mean diag: inducing inputs collide
# mid-optimisation, and the bound stays a bound under any prior jitter
_KMM_EPS_FACTOR = 2000.0


class SVGPParams(NamedTuple):
    kernel_u: Any  # unconstrained kernel params tree
    z: torch.Tensor  # [m, d] inducing inputs
    q_mu: torch.Tensor  # [m] whitened variational mean
    q_sqrt: torch.Tensor  # [m, m] lower-triangular factor of the whitened S
    log_noise: torch.Tensor  # log of the noise variance σ²


def svgp_leaves(params: SVGPParams) -> list:
    """The tensors Adam updates, in a fixed order."""
    return tree_leaves(params.kernel_u) + [params.z, params.q_mu,
                                           params.q_sqrt, params.log_noise]


def init_svgp_params(kernel, x: torch.Tensor, m: int, generator=None,
                     noise: float = 1e-2, xrange=None) -> SVGPParams:
    """The kernel's default hyperparameters for x's range, Z = m distinct
    rows of x (``torch.randperm`` from ``generator``, where the JAX
    package draws ``jr.choice`` without replacement), q(u) = N(0, I)."""
    n, d = x.shape
    if m > n:
        raise ValueError(f"init_svgp_params: m={m} inducing inputs from "
                         f"n={n} rows")
    if xrange is None:
        xrange = torch.stack([x.min(dim=0).values, x.max(dim=0).values],
                             dim=-1).cpu().numpy()
    kp = tree_map(lambda t: t.to(x.device),
                  kernel.init_params(xrange, n, dtype=x.dtype))
    dev = generator.device if generator is not None else x.device
    idx = torch.randperm(n, generator=generator, device=dev)[:m].to(x.device)
    return SVGPParams(
        kernel_u=unconstrain(kernel.positivity(), kp),
        z=x[idx],
        q_mu=torch.zeros(m, dtype=x.dtype, device=x.device),
        q_sqrt=torch.eye(m, dtype=x.dtype, device=x.device),
        log_noise=torch.log(torch.tensor(noise, dtype=x.dtype,
                                         device=x.device)),
    )


def _install(kernel, params: SVGPParams) -> None:
    kernel.set_params(constrain(kernel.positivity(), params.kernel_u))


def _marginals(L_mm, K_mx, q_mu, q_sqrt, k_diag):
    """q(f(x)) marginals from A = L_mm⁻¹K_mx: mean Aᵀq_mu and variance
    k_diag − ‖a‖² + ‖tril(q_sqrt)ᵀa‖² per column, clamped at 1e-12."""
    A = torch.linalg.solve_triangular(L_mm, K_mx, upper=False)  # [m, b]
    mean = A.T @ q_mu
    SA = torch.tril(q_sqrt).T @ A
    var = k_diag - torch.sum(A * A, dim=0) + torch.sum(SA * SA, dim=0)
    return mean, torch.clamp_min(var, 1e-12)


def _whitened_marginals(kernel, z, q_mu, q_sqrt, x, jitter):
    """The ELBO's marginals at the installed hyperparameters, differentiable
    through ``kernel.gram`` (also with respect to z)."""
    K_mm = kernel.gram(z, z)
    L_mm = cholesky_or_nan(add_diag(
        K_mm, effective_jitter(K_mm, jitter, eps_factor=_KMM_EPS_FACTOR)))
    return _marginals(L_mm, kernel.gram(z, x), q_mu, q_sqrt, kernel.diag(x))


def svgp_elbo(kernel, params: SVGPParams, x_batch, y_batch, n_total: int,
              mean: Optional[MeanFunction] = None,
              jitter: float = DEFAULT_CONFIG.jitter) -> torch.Tensor:
    """Minibatch ELBO (Hensman et al. 2013) with the whitened KL
    ½(‖q_mu‖² + ‖L_S‖_F² − 2Σlog|diag L_S| − m); ``log_noise`` is the log
    of the noise variance, σ² = exp(log_noise) + jitter."""
    _install(kernel, params)
    mean = mean if mean is not None else ZeroMean(dim=x_batch.shape[-1])
    resid = y_batch - mean.mean(x_batch)
    f_mean, f_var = _whitened_marginals(kernel, params.z, params.q_mu,
                                        params.q_sqrt, x_batch, jitter)
    noise = torch.exp(params.log_noise) + jitter
    exp_ll = -0.5 * (LOG_2PI + torch.log(noise)
                     + ((resid - f_mean) ** 2 + f_var) / noise)
    scale = n_total / x_batch.shape[0]
    L_S = torch.tril(params.q_sqrt)
    kl = 0.5 * (torch.sum(params.q_mu ** 2) + torch.sum(L_S ** 2)
                - 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(L_S))
                                            + 1e-20))
                - params.q_mu.shape[0])
    return scale * torch.sum(exp_ll) - kl


def collapsed_elbo(kernel, x, y, z, noise,
                   jitter: float = DEFAULT_CONFIG.jitter) -> torch.Tensor:
    """The Titsias collapsed bound at the installed hyperparameters: the
    Nyström log likelihood with the trace correction."""
    return nystroem_mll(kernel, x, y, z, noise, jitter,
                        titsias_correction=True)


@torch.no_grad()
def svgp_predict(kernel, params: SVGPParams, x_test,
                 mean: Optional[MeanFunction] = None,
                 jitter: float = DEFAULT_CONFIG.jitter):
    """q(f) marginals (mean, variance) at x_test, plus the mean function.
    K_mm + floor·I and K_mx come from :func:`dense_gram_for` (the floor
    from ``kernel.diag(z)``, as the ELBO takes it from diag K_mm)."""
    _install(kernel, params)
    z = params.z.detach()  # K5/K6 take no input that requires grad
    floor = effective_jitter_of_diag(kernel.diag(z), jitter,
                                     eps_factor=_KMM_EPS_FACTOR)
    L_mm = cholesky_or_nan(dense_gram_for(kernel, z, z, floor))
    f_mean, f_var = _marginals(L_mm, dense_gram_for(kernel, z, x_test),
                               params.q_mu, params.q_sqrt,
                               kernel.diag(x_test))
    if mean is not None:
        f_mean = f_mean + mean.mean(x_test)
    return f_mean, f_var


def svgp_adam_init(params: SVGPParams, lr: float):
    """(trainable copy of ``params``, ``torch.optim.Adam`` over its
    leaves): the state :func:`svgp_adam_step` advances."""
    flat = [t.detach().clone().requires_grad_(True)
            for t in svgp_leaves(params)]
    k = len(tree_leaves(params.kernel_u))
    trainable = SVGPParams(tree_unflatten(params.kernel_u, flat[:k]),
                           *flat[k:])
    return trainable, torch.optim.Adam(flat, lr=lr)


def svgp_adam_step(kernel, params: SVGPParams, opt, x_batch, y_batch,
                   n_total: int, mean: Optional[MeanFunction] = None,
                   jitter: float = DEFAULT_CONFIG.jitter) -> torch.Tensor:
    """One Adam step on −ELBO over a minibatch; returns the loss (a device
    scalar, before the update). A non-finite loss or gradient feeds Adam a
    zeroed gradient, chosen on the device."""
    leaves = svgp_leaves(params)
    loss = -svgp_elbo(kernel, params, x_batch, y_batch, n_total, mean,
                      jitter)
    grads = torch.autograd.grad(loss, leaves)
    finite = torch.isfinite(loss)
    for g in grads:
        finite = finite & torch.isfinite(g).all()
    for p, g in zip(leaves, grads):
        p.grad = torch.where(finite, g, torch.zeros_like(g))
    opt.step()
    return loss.detach()


def fit_svgp(kernel, x, y, m: int = 128, generator=None,
             batch_size: int = 2048, steps: int = 2000, lr: float = 1e-2,
             noise: float = 1e-2, jitter: float = DEFAULT_CONFIG.jitter,
             mean: Optional[MeanFunction] = None):
    """Adam over the minibatch ELBO. ``generator`` (default: seed 0 on x's
    device) draws Z, then every minibatch, with replacement
    (``torch.randint``: O(batch) a step). Returns (fitted SVGPParams,
    per-step −ELBO history [steps] on x's device) and leaves the fitted
    hyperparameters installed in the kernel; no step reads the host."""
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    n = x.shape[0]
    batch_size = min(batch_size, n)
    params, opt = svgp_adam_init(
        init_svgp_params(kernel, x, m, generator, noise), lr)
    hist = torch.empty(steps, dtype=x.dtype, device=x.device)
    for i in range(steps):
        idx = torch.randint(0, n, (batch_size,), generator=generator,
                            device=generator.device).to(x.device)
        hist[i] = svgp_adam_step(kernel, params, opt, x[idx], y[idx], n,
                                 mean, jitter)
    fitted = SVGPParams(tree_map(torch.Tensor.detach, params.kernel_u),
                        *(t.detach() for t in params[1:]))
    with torch.no_grad():
        _install(kernel, fitted)
    return fitted, hist
