"""Large-scale exact-GP fitting with the distributed factorisation.

Counterpart of ``gaussianprocessfundamentals_tpu/parallel/distributed_fit.py``
(``distributed_nll_value_and_grad`` ``:43``, ``fit_distributed``
``:139``). The NLL's gradient with respect to the kernel hyperparameters
is the contraction of ∂K/∂θ with the cotangent ½(Kₙ⁻¹ − ααᵀ). Kₙ⁻¹ is never
formed: a Nyström approximation C = I/σ² − G·Gᵀ of it is an exact control
variate, and Rademacher probes z estimate only the residual Kₙ⁻¹ − C,

    Kₙ⁻¹ = C + E[sym((Kₙ⁻¹z − Cz)·zᵀ)],

each Kₙ⁻¹z an exact pair of block substitutions against the factor the
forward pass made. The cotangent is then (1/2σ²)·I plus a rank-(2s+m+1)
product U·Wᵀ, contracted over the mesh by K2 (or K4) on each rank's row
panel (:func:`.mesh_matvec.mesh_lowrank_vjp`): no second O(n²) array.

The probes are an argument (the parity tests hand in the JAX package's
``jr.rademacher`` draws) or come from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from gaussianprocessfundamentals_tpu_torch.config import (
    DEFAULT_CONFIG,
    GPConfig,
)
from gaussianprocessfundamentals_tpu_torch.fit.transforms import (
    constrain,
    unconstrain,
)
from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import LOG_2PI
from gaussianprocessfundamentals_tpu_torch.linalg.nystroem import (
    nystroem_factor,
)
from gaussianprocessfundamentals_tpu_torch.models.iterative import (
    cotangent_factor,
)
from gaussianprocessfundamentals_tpu_torch.ops.gram_matvec import (
    grads_or_zeros,
)
from gaussianprocessfundamentals_tpu_torch.parallel.block_cholesky import (
    _factor_inplace,
    cyclic_gram,
    distributed_chol_solve_inv,
)
from gaussianprocessfundamentals_tpu_torch.parallel.mesh_matvec import (
    mesh_lowrank_vjp,
)
from gaussianprocessfundamentals_tpu_torch.parallel.meshes import Mesh
from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def rademacher(generator: torch.Generator, s: int, n: int, like: torch.Tensor
               ) -> torch.Tensor:
    """[s, n] probes of ±1 from ``generator`` (on its own device), in
    like's dtype and device."""
    u = torch.rand((s, n), generator=generator, device=generator.device)
    return torch.where(u < 0.5, -1.0, 1.0).to(like)


def distributed_nll_value_and_grad(
    kernel, x: torch.Tensor, y: torch.Tensor, noise, jitter: float,
    mesh: Mesh, probes: Union[int, torch.Tensor] = 8,
    generator: Optional[torch.Generator] = None, axis: str = "tp",
    block: int = 256,
):
    """(nll, (grad_kernel_params, grad_noise)) at the kernel's installed
    hyperparameters, by the distributed Cholesky and the Hutchinson
    gradient with its Nyström control variate.

    ``probes`` is the probe matrix z [s, n] (±1), or a count s drawn from
    ``generator`` (0: no probes, the control variate alone). Every rank
    passes the same probes (or a generator in the same state). Each rank
    builds only its cyclic block-rows of K + (σ² + jitter)·I
    (:func:`.block_cholesky.cyclic_gram`: K5/K6 on a card), factored in
    place in x's dtype.
    """
    n = x.shape[0]
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device).detach()
    sigma2 = noise + jitter
    if not torch.is_tensor(probes):
        probes = (rademacher(generator, probes, n, x) if probes > 0
                  else x.new_zeros((0, n)))
    z = probes.to(x)
    s = z.shape[0]
    with torch.no_grad():
        # forward: the only O(n²) array, and only this rank's rows of it
        A = cyclic_gram(kernel, x, block, mesh, axis, sigma2)
        Linv, logdet = _factor_inplace(A, mesh, axis)
        solves = distributed_chol_solve_inv(
            A, Linv, torch.cat([y[:, None], z.T], dim=1), mesh, axis)
        del A
        alpha, solves = solves[:, 0], solves[:, 1:].T  # [n], [s, n]
        nll = 0.5 * torch.dot(y, alpha) + 0.5 * logdet + 0.5 * n * LOG_2PI

        # backward: cotangent ½(Kₙ⁻¹ − ααᵀ) with the Nyström control variate
        m = max(16, min(512, n // 8))
        z_ind = x[::max(1, n // m)][:m]
        ny = nystroem_factor(kernel, x, z_ind, sigma2, 1e-6)
        U = torch.linalg.solve_triangular(ny.L_core, ny.A.T, upper=False)
        G = (U.T / torch.sqrt(sigma2.double())).to(x.dtype)  # C = I/σ² − G·Gᵀ
        a = alpha[:, None]
        if s > 0:
            Cz = z / sigma2 - (z @ G) @ G.T
            resid = solves - Cz  # (Kₙ⁻¹ − C)·zᵢ
            R, Z = resid.T, z.T
            U_lr = cotangent_factor([R / (4.0 * s), Z / (4.0 * s), -0.5 * G,
                                     -0.5 * a])
            W_lr = cotangent_factor([Z, R, G, a])
            trace_est = (n / sigma2 - torch.sum(G * G)
                         + torch.mean(torch.sum(z * resid, dim=1)))
        else:
            U_lr = cotangent_factor([-0.5 * G, -0.5 * a])
            W_lr = cotangent_factor([G, a])
            trace_est = n / sigma2 - torch.sum(G * G)
        grad_noise = 0.5 * (trace_est - torch.dot(alpha, alpha))
    # the diagonal (1/2σ²)·I term contracts to (1/2σ²)·∂tr(K)/∂θ
    with kernel.differentiable() as kp, torch.enable_grad():
        tr = torch.sum(kernel.diag(x)) / (2.0 * sigma2)
        diag_grad = tree_unflatten(kp, grads_or_zeros(tr, tree_leaves(kp)))
    g_lr = mesh_lowrank_vjp(kernel, x, U_lr, W_lr, mesh, axis)
    grad_params = tree_map(lambda g, d: g + d, g_lr, diag_grad)
    return nll, (grad_params, grad_noise)


def fit_distributed(
    kernel, x: torch.Tensor, y: torch.Tensor, mesh: Mesh,
    generator: Optional[torch.Generator] = None,
    config: GPConfig = DEFAULT_CONFIG, axis: str = "tp", block: int = 256,
    probes: int = 8, steps: int = 100, lr: float = 0.05,
    optimize_noise: bool = True, init_noise: float = 1e-2, xrange=None,
    probe_draws: Optional[Callable[[int], torch.Tensor]] = None,
):
    """Adam over the distributed NLL (BASELINE config 5's fit loop), with
    ``fit.adam_run``'s update (torch's Adam on the unconstrained leaves
    {"kernel", "log_noise"}).

    Step i's probes are ``probe_draws(i)`` ([probes, n] of ±1) when given,
    else drawn from ``generator`` (default: seed 0 on x's device); every
    rank must draw the same. Returns (kernel_params, noise, history [steps])
    and installs the fitted parameters in the kernel.
    """
    n = x.shape[0]
    if xrange is None:
        xrange = torch.stack([x.min(dim=0).values, x.max(dim=0).values],
                             dim=-1).cpu().numpy()
    if generator is None and probe_draws is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    pos = kernel.positivity()
    u = {"kernel": unconstrain(pos, tree_map(lambda t: t.to(x.device),
                                             kernel.init_params(
                                                 xrange, n, dtype=x.dtype))),
         "log_noise": torch.log(torch.as_tensor(init_noise, dtype=x.dtype,
                                                device=x.device))}
    u = tree_map(lambda t: t.detach().clone().requires_grad_(True), u)
    leaves = tree_leaves(u)
    opt = torch.optim.Adam(leaves, lr=lr)
    fixed = torch.as_tensor(init_noise, dtype=x.dtype, device=x.device)
    hist = []
    for i in range(steps):
        ud = tree_map(torch.Tensor.detach, u)
        kp = constrain(pos, ud["kernel"])
        kernel.set_params(kp)
        noise = torch.exp(ud["log_noise"]) if optimize_noise else fixed
        z = probe_draws(i) if probe_draws is not None else probes
        nll, (g_kp, g_noise) = distributed_nll_value_and_grad(
            kernel, x, y, noise, config.jitter, mesh, z, generator, axis,
            block)
        # the chain rule through the log reparameterisation
        g_u = {"kernel": tree_map(lambda g, p, is_pos: g * p if is_pos else g,
                                  g_kp, kp, pos),
               "log_noise": (g_noise * noise if optimize_noise
                             else torch.zeros_like(noise))}
        for p, g in zip(leaves, tree_leaves(tree_map(lambda _, g: g, u, g_u))):
            p.grad = g.to(p.dtype)
        opt.step()
        hist.append(nll.detach())
    ud = tree_map(torch.Tensor.detach, u)
    kp = constrain(pos, ud["kernel"])
    kernel.set_params(kp)
    noise = torch.exp(ud["log_noise"]) if optimize_noise else fixed
    return kp, noise, torch.stack(hist)
