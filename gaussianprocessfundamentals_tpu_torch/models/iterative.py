"""Iterative (factorisation-free) exact GP: the large-n fitting and serving
paths.

Counterpart of ``gaussianprocessfundamentals_tpu/models/iterative.py``:

* the NLL half (``:35-752``): ``_cot_vjp``, ``_core_impl``,
  ``iterative_nll_and_grad`` and ``fit_iterative`` (Adam over the mBCG +
  SLQ NLL with its step guard);
* the posterior half: ``build_preconditioner`` (``:64``), ``apply_P_inv``
  (``:165``), ``iterative_posterior_mean`` (``:767``),
  ``iterative_posterior`` (``:838``) and the chunked route
  ``iterative_posterior_chunked`` (``:926``) with its setup and chunk steps
  (``:886``, ``:908``).

Above 40k rows K is never formed: every Kₙ·V goes through
:func:`..ops.cuda_gram.fused_matvec_for` (K1) and the gradient's low-rank
contraction through :func:`..ops.cuda_lrvjp.fused_lowrank_vjp_for` (K2),
the CUDA kernels on a card and their plain versions on the CPU. A
posterior's cross-covariance K_s, one [n, chunk] block per test chunk, is
built by :func:`..ops.cuda_dense_gram.dense_gram_for` (K5 or K6 for SE and
Matérn leaves on a card).

The NLL's probes are arguments of :func:`_core_impl` (u [n, s] and
w [m, s] standard-normal draws); the public functions draw them from an
explicit ``torch.Generator``. The JAX package drew them from a key inside
its core, a stream torch cannot replay, so the parity tests hand both
cores the same numbers. Not ported: ``block`` and ``scan_chunk`` (TPU
program-size knobs), the per-step fallback and the vmapped-restart
program; restarts run one after another.

Under a ``mesh`` (:mod:`..parallel.meshes`, one process per rank; JAX
``:194-275``, ``:865-970``) every Kₙ·V is the mesh-sharded product
:func:`..parallel.mesh_matvec.mesh_matvec_for` (each rank's row panel
through K1 or K3, then one all-gather) and the gradient's contraction
:func:`..parallel.mesh_matvec.mesh_lowrank_vjp_for` (K2 or K4 on each
panel, then one all-reduce); ``materialize=True`` holds each rank's
resident K(x_loc, x) panel instead. The preconditioner, the probes and the
CG state are replicated: every rank draws the same probes from the same
seed. The decisions that steer a collective are settled across the ranks:
CG's early exit and the step guard by one all-reduce each.

Numerics that differ from the JAX package, because the H100 has native
float64 and fast batched QR:

* the thin QR of the preconditioner factor is plain ``torch.linalg.qr`` at
  every n (the JAX package's TSQR only worked around batched XLA:TPU QR);
* the small [m, m] SVD is ``torch.linalg.svd`` in float64, in place of the
  float32 one-sided Jacobi SVD, keeping small singular values at least as
  accurate;
* the variance's two column dots accumulate in float64, in place of the
  double-float32 arithmetic;
* the SLQ eigensolves are one batched float64 ``torch.linalg.eigh`` on the
  device (:func:`..linalg.mbcg.slq_logdet`).
"""
from __future__ import annotations

import functools
import warnings
from typing import Optional

import torch

from gaussianprocessfundamentals_tpu_torch.fit.transforms import (
    assign_leaves,
    constrain,
    leaf_copy,
    unconstrain,
)
from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import LOG_2PI
from gaussianprocessfundamentals_tpu_torch.linalg.mbcg import mbcg, slq_logdet
from gaussianprocessfundamentals_tpu_torch.linalg.pivchol import (
    partial_pivoted_cholesky,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
    fused_matvec_cross_for,
    fused_matvec_for,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_dense_gram import (
    dense_gram_for,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_lrvjp import (
    fused_lowrank_vjp_for,
)
from gaussianprocessfundamentals_tpu_torch.ops.gram_matvec import grads_or_zeros
from gaussianprocessfundamentals_tpu_torch.parallel.mesh_matvec import (
    mesh_lowrank_vjp_for,
    mesh_matvec_for,
)
from gaussianprocessfundamentals_tpu_torch.parallel.meshes import (
    agree_all_done,
    agree_any,
    all_gather_rows,
    all_reduce_tree,
    pad_to,
    row_range,
)
from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

# _core_impl builds K once (plain matmuls in CG, the Gram's own autograd
# graph for the gradient) up to this many rows, and streams above it
# (JAX iterative.py:259-260): a float32 K is 6.4 GB at 40k
_MATERIALIZE_MAX_N = 40_000


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


def cotangent_factor(cols):
    """The columns side by side as one [n, r'] factor of the low-rank
    cotangent U·Wᵀ, with zero columns up to r' a multiple of 4: they add
    exactly nothing to U·Wᵀ, and rows of such a width let K2/K4 copy U and
    W 16 bytes at a time (a ragged r takes 4-byte copies, which are
    slower: PERF.md §5). Made in the concatenation the NLL
    needs anyway, so no further copy."""
    r = sum(c.shape[1] for c in cols)
    pad = -r % 4
    if pad:
        cols = list(cols) + [cols[0].new_zeros((cols[0].shape[0], pad))]
    return torch.cat(cols, dim=1)


def _cot_vjp(kernel, x, U, W, dense_gram_vjp, mesh=None,
             mesh_axis: str = "tp"):
    """Contract the low-rank cotangent U·Wᵀ with ∂K/∂θ: through the Gram's
    own autograd graph when K (or the rank's panel of it) is materialised,
    under a mesh through the sharded panel contraction, else K2 on a card
    or the plain streamed VJP on the CPU."""
    if dense_gram_vjp is not None:
        return dense_gram_vjp(U, W)
    if mesh is not None:
        return mesh_lowrank_vjp_for(kernel, x, mesh, mesh_axis)(U, W)
    return fused_lowrank_vjp_for(kernel, x)(U, W)


def _resident_panel(kernel, x, noise, kp, leaves, mesh, mesh_axis):
    """(matvec, dense_gram_vjp) from K held whole, or under a mesh from
    this rank's resident row panel K(x_loc, x): its products are
    all-gathered and its parameter gradients all-reduced."""
    if mesh is None:
        x_loc, start, stop = x, 0, x.shape[0]
    else:
        start, stop, rows = row_range(x.shape[0], mesh, mesh_axis)
        x_loc = x[start:stop]
    with torch.enable_grad():
        K = kernel.gram(x_loc, x)
    Kd = K.detach()

    def matvec(V):
        if mesh is None:
            return Kd @ V + noise * V
        out = all_gather_rows(pad_to(Kd @ V, rows), mesh, mesh_axis)
        return out[:x.shape[0]] + noise * V

    def dense_gram_vjp(U, W):
        g = tree_unflatten(kp, grads_or_zeros(K, leaves, U[start:stop] @ W.T))
        return g if mesh is None else all_reduce_tree(g, mesh, mesh_axis)

    return matvec, dense_gram_vjp


def _core_impl(kernel, x, y, noise, u, w=None, max_iters: int = 100,
               tol: float = 1e-6, precond_m: int = 128,
               early_exit: bool = True, materialize: Optional[bool] = None,
               mean=None, mesh=None, mesh_axis: str = "tp"):
    """(data_fit, log_P, alphas, betas, z_weights, grad_params, grad_noise,
    grad_mean, resid) for the kernel's and mean's installed parameters,
    without forming K above ``_MATERIALIZE_MAX_N`` rows.

    ``u`` [n, s] and ``w`` [m, s] are standard-normal draws: with
    ``precond_m > 0`` the probes are z = σu + W_b·diag(sv)·w ~ N(0, P) for
    the rank-m pivoted-Cholesky preconditioner P = σ²I + AAᵀ; with
    ``precond_m = 0`` (no preconditioner) ``u`` is the probe matrix itself
    (the public functions draw it Rademacher) and ``w`` is unused.

    The gradient cotangent ½(Kₙ⁻¹ − ααᵀ) uses P⁻¹ as an exact low-rank
    control variate, Kₙ⁻¹ = P⁻¹ + E[sym((Ẑ − P⁻¹Z)(P⁻¹Z)ᵀ)], so it is rank
    2s + m + 1 plus the diagonal I/(2σ²) term. ``resid`` is the relative
    residual ‖r‖/‖b‖ per CG column; ``grad_mean`` = −(∂m/∂mp)ᵀα comes from
    the same solve. The solves run without autograd; only the Gram VJP,
    the diagonal term and the mean's VJP differentiate.

    With a ``mesh`` the products and the contraction are sharded over
    ``mesh_axis`` (streamed by default; ``materialize=True`` holds each
    rank's K panel) and every output is replicated.
    """
    n = x.shape[0]
    s = u.shape[1]
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device).detach()
    if mean is not None:
        with mean.differentiable() as mp, torch.enable_grad():
            m_of_x = mean.mean(x)
        y = y - m_of_x.detach()
    if materialize is None:
        materialize = mesh is None and n <= _MATERIALIZE_MAX_N
    with kernel.differentiable() as kp:
        leaves = tree_leaves(kp)
        dense_gram_vjp = None
        with torch.no_grad():
            if materialize:
                matvec, dense_gram_vjp = _resident_panel(
                    kernel, x, noise, kp, leaves, mesh, mesh_axis)
            else:
                matvec = _noised_matvec(kernel, x, noise, mesh, mesh_axis)

            if precond_m > 0:
                m = min(precond_m, n)
                P_inv, W_b, sv, _, log_P = build_preconditioner(
                    kernel, x, m, noise)
                # z ~ N(0, P): cov(σu + W·diag(sv)·w) = σ²I + W sv² Wᵀ = P
                z = torch.sqrt(noise) * u + W_b @ (sv[:, None] * w)
                zt = P_inv(z)  # P⁻¹z, also the SLQ e₁ weights zᵀP⁻¹z
            else:
                P_inv = None
                log_P = torch.zeros((), dtype=x.dtype, device=x.device)
                z = zt = u
            z_weights = torch.sum(z * zt, dim=0)

            B = torch.cat([y[:, None], z], dim=1)
            res = mbcg(matvec, B, max_iters=max_iters, tol=tol,
                       precond=P_inv, early_exit=early_exit,
                       all_done=_all_done(mesh))
            alpha = res.solves[:, 0]
            zhat = res.solves[:, 1:]
            col_norms = torch.linalg.norm(B, dim=0)
            resid_rel = res.resid_norm / torch.clamp_min(
                col_norms, torch.finfo(B.dtype).tiny)
            data_fit = torch.dot(y, alpha)

            if precond_m > 0:
                # P⁻¹ = I/σ² − G·Gᵀ with G = W_b·diag(√(sv²/(σ²(sv²+σ²))))
                G = W_b * torch.sqrt(sv * sv / (noise * (sv * sv + noise)))[None, :]
                rhat = zhat - zt  # (Kₙ⁻¹ − P⁻¹)Z
                U = cotangent_factor([rhat / (4.0 * s), zt / (4.0 * s),
                                      -0.5 * G, -0.5 * alpha[:, None]])
                W = cotangent_factor([zt, rhat, G, alpha[:, None]])
                trace_est = (n / noise - torch.sum(G * G)
                             + torch.mean(torch.sum(zt * rhat, dim=0)))
            else:
                U = cotangent_factor([zhat / (4.0 * s), zt / (4.0 * s),
                                      -0.5 * alpha[:, None]])
                W = cotangent_factor([zt, zhat, alpha[:, None]])
                trace_est = torch.mean(torch.sum(zt * zhat, dim=0))
            grad_noise = 0.5 * (trace_est - torch.dot(alpha, alpha))

        grad_params = _cot_vjp(kernel, x, U, W, dense_gram_vjp, mesh,
                               mesh_axis)
        if precond_m > 0:
            # the diagonal I/(2σ²) term contracts to (1/2σ²)·∂tr(K)/∂θ
            with torch.enable_grad():
                tr = torch.sum(kernel.diag(x)) / (2.0 * noise)
            diag_grad = tree_unflatten(kp, grads_or_zeros(tr, leaves))
            grad_params = tree_map(lambda a, b: a + b, grad_params, diag_grad)
    grad_mean = {}
    if mean is not None:
        grad_mean = tree_unflatten(mp, grads_or_zeros(
            m_of_x, tree_leaves(mp), -alpha))
    return (data_fit, log_P, res.alphas[:, 1:], res.betas[:, 1:], z_weights,
            grad_params, grad_noise, grad_mean, resid_rel)


def draw_probes(x, n_probes: int, m: int, generator=None):
    """The core's (u [n, s], w [m, s]) draws from ``generator`` (or the
    global stream of x's device): standard normal, or ``u`` Rademacher and
    no ``w`` when ``m == 0`` (no preconditioner)."""
    dev = generator.device if generator is not None else x.device
    shape_u = (x.shape[0], n_probes)
    u = torch.randn(shape_u, generator=generator, dtype=x.dtype, device=dev)
    if m == 0:
        return torch.where(u >= 0, 1.0, -1.0).to(x), None
    w = torch.randn((m, n_probes), generator=generator, dtype=x.dtype,
                    device=dev)
    return u.to(x.device), w.to(x.device)


def iterative_nll_and_grad(
    kernel, x, y, noise, generator=None, num_probes: int = 8,
    max_iters: int = 100, tol: float = 1e-6, precond_m: int = 128,
    early_exit: bool = True, materialize: Optional[bool] = None, mean=None,
    mesh=None, mesh_axis: str = "tp",
):
    """(nll, grad_kernel_params, grad_noise, resid[, grad_mean]) of the
    exact-GP NLL at the kernel's and mean's installed parameters, by mBCG
    and SLQ; ``grad_mean`` is appended iff ``mean`` is given. The probes
    come from ``generator`` (under a ``mesh`` every rank must pass a
    generator in the same state). Everything stays on x's device: the SLQ
    eigensolves are a batched float64 ``eigh`` there."""
    n = x.shape[0]
    m = min(precond_m, n) if precond_m > 0 else 0
    u, w = draw_probes(x, num_probes, m, generator)
    (data_fit, log_P, al, be, zw, grad_params, grad_noise, grad_mean,
     resid) = _core_impl(kernel, x, y, noise, u, w, max_iters, tol,
                         precond_m, early_exit, materialize, mean, mesh,
                         mesh_axis)
    logdet = log_P.double() + slq_logdet(al, be, zw)
    nll = (0.5 * data_fit.double() + 0.5 * logdet
           + 0.5 * n * LOG_2PI).to(x.dtype)
    if mean is not None:
        return nll, grad_params, grad_noise, resid, grad_mean
    return nll, grad_params, grad_noise, resid


def _step_guard(nll, g_u, resid, resid_guard, mesh=None):
    """True (a device bool) when a step must be skipped: a non-finite
    gradient or NLL, or with ``resid_guard`` a median relative CG residual
    above it. The median, not the max: at large n one probe column always
    sits at its float32 floor, while the runaway into an ill-conditioned
    region shows as most columns degrading at once. Under a ``mesh`` the
    step is skipped on every rank when any rank would skip it, so the
    replicated parameters stay equal."""
    finite = torch.stack([torch.isfinite(g).all() for g in tree_leaves(g_u)]
                         + [torch.isfinite(nll)])
    bad = ~finite.all()
    if resid_guard is not None:
        bad = (bad | ~torch.isfinite(resid).all()
               | ~(torch.quantile(resid, 0.5) <= resid_guard))
    return bad if mesh is None else agree_any(bad, mesh)


def _adam_iterative(kernel, mean, x, y, u0, generator, steps, lr,
                    optimize_noise, init_noise, resid_guard, project,
                    callback, core_kw):
    """One Adam run over the iterative NLL from ``u0``; returns the final
    unconstrained params, the NLL history and the per-step skip flags.

    A skipped step zeroes its gradient, lets Adam advance its moments and
    step count on it, and keeps the params: the JAX package's
    ``guard_update`` (``iterative.py:586-624``) step for step.
    """
    pos = kernel.positivity()
    mpos = mean.positivity() if mean is not None else {}
    u = leaf_copy(u0, project)
    leaves = tree_leaves(u)
    opt = torch.optim.Adam(leaves, lr=lr)
    init_noise_t = torch.as_tensor(init_noise, dtype=x.dtype, device=x.device)
    hist, bads = [], []
    for i in range(steps):
        ud = tree_map(torch.Tensor.detach, u)
        kp = constrain(pos, ud["kernel"])
        kernel.set_params(kp)
        noise = torch.exp(ud["log_noise"]) if optimize_noise else init_noise_t
        if mean is not None:
            mp = constrain(mpos, ud["mean"])
            mean.set_params(mp)
            nll, g_kp, g_noise, resid, g_mp = iterative_nll_and_grad(
                kernel, x, y, noise, generator, mean=mean, **core_kw)
        else:
            nll, g_kp, g_noise, resid = iterative_nll_and_grad(
                kernel, x, y, noise, generator, **core_kw)
        # chain rule through the log-reparameterisation
        chain = lambda g, p, is_pos: g * p if is_pos else g  # noqa: E731
        g_u = {"kernel": tree_map(chain, g_kp, kp, pos),
               "log_noise": (g_noise * noise if optimize_noise
                             else torch.zeros_like(noise))}
        if mean is not None:
            g_u["mean"] = tree_map(chain, g_mp, mp, mpos)
        g_u = tree_map(lambda _, g: g, u, g_u)  # u's leaf order
        bad = _step_guard(nll, g_u, resid, resid_guard, core_kw.get("mesh"))
        before = [p.detach().clone() for p in leaves]
        for p, g in zip(leaves, tree_leaves(g_u)):
            p.grad = torch.where(bad, torch.zeros_like(g), g).to(p.dtype)
        opt.step()
        if project is not None:
            assign_leaves(u, project(u))
        with torch.no_grad():
            for p, b in zip(leaves, before):
                p.copy_(torch.where(bad, b, p))
        hist.append(nll.detach())
        bads.append(bad)
        if callback is not None:
            callback(i, float(nll))
    return tree_map(torch.Tensor.detach, u), torch.stack(hist), torch.stack(bads)


def fit_iterative(
    kernel, x, y, generator=None, steps: int = 100, lr: float = 0.05, num_probes: int = 8,
    max_iters: int = 100, optimize_noise: bool = True,
    init_noise: float = 1e-2, xrange=None, callback=None, tol: float = 1e-6,
    precond_m: int = 128, early_exit: bool = True,
    resid_guard: Optional[float] = None, materialize: Optional[bool] = None,
    return_diagnostics: bool = False, init_generator=None, mean=None,
    enforce_bounds: bool = False, restarts: int = 0, mesh=None,
    mesh_axis: str = "tp",
):
    """Adam over the iterative NLL: exact-GP fitting at N = 100k+ scale.

    Returns ``(kernel_params, noise, history[, diagnostics])``, or with a
    ``mean`` ``(kernel_params, mean_params, noise, history[,
    diagnostics])``, as the JAX package does; the fitted parameters are
    also installed in the kernel and mean modules.

    * ``generator`` draws every step's probes (default: seed 0 on x's
      device); ``init_generator`` draws a random initial point inside the
      bounds (default: the kernel's and mean's deterministic defaults).
    * ``resid_guard`` skips steps whose median relative CG residual is
      above it, and non-finite steps are always skipped;
      ``diagnostics["frozen_frac"]`` is the share of skipped steps (near
      1.0 means the fit did nothing and returned its initial point).
    * ``enforce_bounds`` clips the kernel hyperparameters into
      ``kernel.bounds(xrange, n)`` after every update.
    * ``restarts > 0`` runs that many extra fits from random initial
      points inside the bounds, one after another, each on the same probe
      stream; the best final NLL wins, NaN-safe.
    * ``mesh`` shards every product over ``mesh_axis`` (:func:`_core_impl`);
      each rank calls this with the same data and a generator in the same
      state. Restarts are refused there, as in the JAX package: run them as
      the dp axis (``parallel.sharded.restart_sharded_fit_step``) or one
      after another (``fit.fit`` does).
    """
    from gaussianprocessfundamentals_tpu_torch.fit.fit import bounds_projection

    if restarts > 0 and mesh is not None:
        raise ValueError(
            "fit_iterative(restarts>0, mesh=...): restarts and mesh sharding "
            "compose as a dp×tp mesh; use "
            "parallel.sharded.restart_sharded_fit_step or run restarts "
            "sequentially")
    n = x.shape[0]
    if xrange is None:
        xrange = torch.stack([x.min(dim=0).values, x.max(dim=0).values],
                             dim=-1).cpu().numpy()
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    project = (bounds_projection(kernel, xrange, n) if enforce_bounds
               else None)
    pos = kernel.positivity()
    mpos = mean.positivity() if mean is not None else {}

    def make_u0(g):
        to_x = lambda t: t.to(x.device)  # noqa: E731
        u0 = {
            "kernel": unconstrain(pos, tree_map(to_x, kernel.init_params(
                xrange, n, generator=g, dtype=x.dtype))),
            "log_noise": torch.log(torch.as_tensor(init_noise, dtype=x.dtype,
                                                   device=x.device)),
        }
        if mean is not None:
            u0["mean"] = unconstrain(mpos, tree_map(to_x, mean.init_params(
                xrange, n, generator=g, dtype=x.dtype)))
        return u0

    core_kw = dict(num_probes=num_probes, max_iters=max_iters, tol=tol,
                   precond_m=precond_m, early_exit=early_exit,
                   materialize=materialize, mesh=mesh, mesh_axis=mesh_axis)
    probe_state = generator.get_state()
    best = None
    for i in range(restarts + 1):
        g_init = init_generator if i == 0 else torch.Generator().manual_seed(
            generator.initial_seed() + 0xA110 + i)
        generator.set_state(probe_state)
        run = _adam_iterative(
            kernel, mean, x, y, make_u0(g_init), generator, steps, lr,
            optimize_noise, init_noise, resid_guard, project, callback,
            core_kw)
        final = float(run[1][-1])
        # NaN-safe: a non-finite incumbent always loses to a finite
        # challenger
        if best is None or (final == final and not best[0] <= final):
            best = (final, run)
    u, hist, bads = best[1]
    kp = constrain(pos, u["kernel"])
    kernel.set_params(kp)
    noise = (torch.exp(u["log_noise"]) if optimize_noise
             else torch.as_tensor(init_noise, dtype=x.dtype, device=x.device))
    out = (kp,)
    if mean is not None:
        mp = constrain(mpos, u["mean"])
        mean.set_params(mp)
        out = out + (mp,)
    out = out + (noise, hist)
    if return_diagnostics:
        return out + ({"frozen_frac": float(bads.float().mean())},)
    return out


def _posterior_precond(kernel, x, noise, precond_m):
    if precond_m <= 0:
        return None
    P_inv, _, _, _, _ = build_preconditioner(
        kernel, x, min(precond_m, x.shape[0]), noise
    )
    return P_inv


def _noised_matvec(kernel, x, noise, mesh=None, mesh_axis: str = "tp"):
    """Kₙ·V = (K + σ²I)·V through K1 or K3 (their plain version on the
    CPU), over the mesh when one is given."""
    kmv = (fused_matvec_for(kernel, x) if mesh is None
           else mesh_matvec_for(kernel, x, mesh, mesh_axis))
    return lambda V: kmv(V) + noise * V


def _all_done(mesh):
    return None if mesh is None else agree_all_done(mesh)


def _true_rel_resid(KnX, B) -> torch.Tensor:
    """‖Kₙx − b‖/‖b‖ per column, from a product already computed (the CG
    recurrence's own residual drifts below the attainable one)."""
    b = torch.linalg.norm(B, dim=0)
    r = torch.linalg.norm(KnX - B, dim=0)
    return r / torch.where(b > 0, b, torch.ones_like(b))


@torch.no_grad()
def iterative_posterior_mean(
    kernel, x, y, x_test, noise, max_iters: int = 200, tol: float = 1e-8,
    precond_m: int = 128, mesh=None, mesh_axis: str = "tp",
):
    """μ* = K(x_test, x)·Kₙ⁻¹y with a preconditioned CG solve (its products
    over the mesh when one is given)."""
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    res = mbcg(_noised_matvec(kernel, x, noise, mesh, mesh_axis),
               y[:, None], max_iters=max_iters, tol=tol,
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
    precond_m: int = 128, mesh=None, mesh_axis: str = "tp",
):
    """(μ*, var*) from one mBCG solve against [y | K_s]; variances in the
    energy form at the price of one extra Kₙ·V (its products over the mesh
    when one is given)."""
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    matvec = _noised_matvec(kernel, x, noise, mesh, mesh_axis)
    K_s = dense_gram_for(kernel, x, x_test)  # [n, t]
    B = torch.cat([y[:, None], K_s], dim=1)
    res = mbcg(matvec, B, max_iters=max_iters, tol=tol,
               precond=_posterior_precond(kernel, x, noise, precond_m),
               early_exit=True, all_done=_all_done(mesh))
    alpha = res.solves[:, 0]
    V = res.solves[:, 1:]
    var, _ = _variance_energy_f64(kernel, x_test, K_s, V, matvec(V))
    return K_s.T @ alpha, var


def _posterior_setup(kernel, x, y, noise, m, max_iters, tol, mesh=None,
                     mesh_axis: str = "tp"):
    """Preconditioner build + the single y-solve. ``m == 0`` degrades to
    P = σ²I (a zero basis)."""
    n = x.shape[0]
    if m > 0:
        P_inv, W_b, _, d_rng, _ = build_preconditioner(kernel, x, m, noise)
    else:
        W_b = torch.zeros((n, 1), dtype=x.dtype, device=x.device)
        d_rng = torch.zeros((1,), dtype=x.dtype, device=x.device)
        P_inv = functools.partial(apply_P_inv, W_b, d_rng, noise)
    matvec = _noised_matvec(kernel, x, noise, mesh, mesh_axis)
    B = y[:, None]
    res = mbcg(matvec, B, max_iters=max_iters, tol=tol, precond=P_inv,
               early_exit=True, all_done=_all_done(mesh))
    alpha = res.solves
    return (alpha[:, 0], W_b, d_rng, res.iters,
            _true_rel_resid(matvec(alpha), B))


def _posterior_chunk(kernel, x, alpha, xt, noise, W_b, d_rng, max_iters, tol,
                     mesh=None, mesh_axis: str = "tp"):
    """One test-point chunk, reusing the prebuilt basis and y-solve."""
    matvec = _noised_matvec(kernel, x, noise, mesh, mesh_axis)
    K_s = dense_gram_for(kernel, x, xt)  # [n, c]
    res = mbcg(matvec, K_s, max_iters=max_iters, tol=tol,
               precond=functools.partial(apply_P_inv, W_b, d_rng, noise),
               early_exit=True, all_done=_all_done(mesh))
    V = res.solves
    KnV = matvec(V)
    var, floor = _variance_energy_f64(kernel, xt, K_s, V, KnV)
    return K_s.T @ alpha, var, floor, res.iters, _true_rel_resid(KnV, K_s)


@torch.no_grad()
def iterative_posterior_chunked(
    kernel, x, y, x_test, noise, max_iters: int = 100, tol: float = 1e-6,
    precond_m: int = 128, chunk: int = 256, stats: Optional[dict] = None,
    mesh=None, mesh_axis: str = "tp",
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
    Kₙ·V. With a ``mesh`` every Kₙ·V is sharded over ``mesh_axis``
    (prediction scales over the ranks as training does); K_s and the
    outputs are replicated.
    """
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    m = min(precond_m, x.shape[0]) if precond_m > 0 else 0
    alpha, W_b, d_rng, it, rel = _posterior_setup(
        kernel, x, y, noise, m, max_iters, tol, mesh, mesh_axis
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
            kernel, x, alpha, xt, noise, W_b, d_rng, max_iters, tol, mesh,
            mesh_axis
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
