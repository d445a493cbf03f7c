"""Plain PyTorch reference of the exact Gaussian process the benchmark runs.

It imports torch, numpy and the standard library only: nothing of the
program under test, nothing of JAX. Everything is written from the
mathematics of an exact GP with a pivoted-Cholesky preconditioner and
stochastic Lanczos quadrature (Gardner et al. 2018, "GPyTorch: Blackbox
Matrix-Matrix Gaussian Process Inference with GPU Acceleration"), in the
precision the caller asks for (float64 for the reference, float32 with TF32
for the lower-precision control).

* Kernels and means are evaluated from the configuration's description
  (the same ``{"type": ..., "children": [...]}`` trees the configuration
  files hold): sums and products here, each leaf from its own file under
  ``leaves/``; parameters are trees of tensors in the pytree order of dict
  keys sorted, children in order.
* :class:`SymGram` stores K(x, x) as its lower block triangle (half of K:
  40 GB in float64 at n = 100,000) and multiplies it by V in the storage
  precision.
* :func:`nll_and_grad` is the stochastic NLL estimate and its gradient for
  given probe draws and a given preconditioner basis; :func:`follow_fit`
  runs Adam over it for a few steps.
* :func:`posterior` is the exact posterior mean and variance by a
  preconditioned CG solve run to its floor.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from gpbench.reference.leaves import leaf

LOG_2PI = math.log(2.0 * math.pi)

_OPERATORS = ("Sum", "Product", "MeanSum", "MeanProduct")


# --- parameter trees ---------------------------------------------------------

def param_names(desc: dict) -> tuple:
    names = tuple(leaf(desc["type"]).PARAMS)
    if desc.get("scaled"):
        names = names + ("variance",)
    return tuple(sorted(names))


def param_specs(desc: dict, prefix: str = "") -> List[tuple]:
    """[(path, positive)] of every parameter leaf, in pytree order."""
    if desc["type"] in _OPERATORS:
        out = []
        for i, c in enumerate(desc["children"]):
            out += param_specs(c, f"{prefix}{i}.")
        return out
    signed = leaf(desc["type"]).SIGNED
    return [(prefix + name, name not in signed) for name in param_names(desc)]


def unflatten(desc: dict, flat: Sequence[torch.Tensor]) -> dict:
    """The parameter tree of ``desc`` from its leaves in pytree order."""
    it = iter(flat)

    def build(d):
        if d["type"] in _OPERATORS:
            return {"children": tuple(build(c) for c in d["children"])}
        return {name: next(it) for name in param_names(d)}

    tree = build(desc)
    if next(it, None) is not None:
        raise ValueError("more parameter leaves than the description takes")
    return tree


def flatten(desc: dict, tree: dict) -> List[torch.Tensor]:
    if desc["type"] in _OPERATORS:
        return [t for c, p in zip(desc["children"], tree["children"])
                for t in flatten(c, p)]
    return [tree[name] for name in param_names(desc)]


def default_params(desc: dict, xmin: np.ndarray, xmax: np.ndarray,
                   dtype=torch.float64) -> dict:
    """The stated starting point of a fit: each leaf's (its ``start``, from
    the range of the first input dimension), variances 0.1."""
    r = float(np.float32(xmax[0]) - np.float32(xmin[0]))
    r = r if r > 0 else 1.0

    def build(dd):
        if dd["type"] in _OPERATORS:
            return {"children": tuple(build(c) for c in dd["children"])}
        own = dict(leaf(dd["type"]).start(r, xmin, xmax), variance=0.1)
        return {name: torch.as_tensor(np.asarray(own[name]), dtype=dtype)
                for name in param_names(dd)}

    return build(desc)


def tree_to(tree, **kw):
    if isinstance(tree, dict):
        return {k: tree_to(v, **kw) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_to(v, **kw) for v in tree)
    return torch.as_tensor(tree).to(**kw)


# --- kernels and means -------------------------------------------------------

def kernel_value(desc: dict, p: dict, x1: torch.Tensor,
                 x2: torch.Tensor) -> torch.Tensor:
    """K(x1, x2) [n1, n2] of the described covariance."""
    t = desc["type"]
    if t == "Sum":
        out = None
        for c, pc in zip(desc["children"], p["children"]):
            k = kernel_value(c, pc, x1, x2)
            out = k if out is None else out + k
        return out
    if t == "Product":
        out = None
        for c, pc in zip(desc["children"], p["children"]):
            k = kernel_value(c, pc, x1, x2)
            out = k if out is None else out * k
        return out
    k = leaf(t).value(p, x1, x2)
    if desc.get("scaled"):
        k = p["variance"] * k
    return k


def kernel_diag(desc: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    t = desc["type"]
    if t in ("Sum", "Product"):
        parts = [kernel_diag(c, pc, x)
                 for c, pc in zip(desc["children"], p["children"])]
        out = parts[0]
        for q in parts[1:]:
            out = out + q if t == "Sum" else out * q
        return out
    k = leaf(t).diag(p, x)
    if desc.get("scaled"):
        k = p["variance"] * k
    return k


def mean_value(desc: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    t = desc["type"]
    if t in ("MeanSum", "MeanProduct"):
        parts = [mean_value(c, pc, x)
                 for c, pc in zip(desc["children"], p["children"])]
        out = parts[0]
        for q in parts[1:]:
            out = out + q if t == "MeanSum" else out * q
        return out
    return leaf(t).value(p, x)


# --- K stored as its lower block triangle ------------------------------------

class SymGram:
    """K(x, x) + diag_add·I held as block rows of its lower triangle, in
    ``dtype``: row block i holds K[rows_i, :end_i]. ``matvec`` forms
    K·V from each block and its transpose, in the storage precision (with
    float32 storage, torch's TF32 flag decides the products' precision)."""

    def __init__(self, desc, p, x, dtype, block: int = 2048, diag_add=0.0):
        self.n = x.shape[0]
        self.bounds = [(s, min(s + block, self.n))
                       for s in range(0, self.n, block)]
        self.dtype = dtype
        xd = x.to(dtype)
        pd = tree_to(p, dtype=dtype, device=x.device)
        self.blocks = []
        with torch.no_grad():
            for s, e in self.bounds:
                k = kernel_value(desc, pd, xd[s:e], xd[:e])
                if diag_add:
                    idx = torch.arange(e - s, device=x.device)
                    k[idx, s + idx] += diag_add
                self.blocks.append(k)

    def matvec(self, V: torch.Tensor) -> torch.Tensor:
        V = V.to(self.dtype)
        out = torch.zeros_like(V)
        for (s, e), k in zip(self.bounds, self.blocks):
            out[s:e] += k @ V[:e]
            if s:
                out[:s] += k[:, :s].T @ V[s:e]
        return out

    def free(self):
        self.blocks = []


# --- pivoted Cholesky, the preconditioner, CG, SLQ ---------------------------

def pivoted_cholesky(desc, p, x, k: int, floor_eps: float) -> torch.Tensor:
    """Greedy rank-k pivoted Cholesky factor L [n, k], LLᵀ ≈ K(x, x): each
    step takes the largest remaining diagonal; a pivot at or below
    100·floor_eps·max(diag) freezes its column at zero."""
    n = x.shape[0]
    diag = kernel_diag(desc, p, x).clone()
    floor = 100.0 * floor_eps * torch.max(diag)
    L = torch.zeros((n, k), dtype=x.dtype, device=x.device)
    for i in range(k):
        j = int(torch.argmax(diag))
        piv = diag[j]
        if not piv > floor:
            break
        col = kernel_value(desc, p, x, x[j:j + 1])[:, 0] - L @ L[j]
        col = col / torch.sqrt(piv)
        col[j] = torch.sqrt(piv)
        L[:, i] = col
        diag = torch.clamp_min(diag - col * col, 0.0)
        diag[j] = 0.0
    return L


def apply_p_inv(W, d_rng, noise, V):
    """(σ²I + W·diag(sv²)·Wᵀ)⁻¹V for an orthonormal basis W, with
    d_rng = 1/(sv² + σ²), the complement projection applied twice."""
    c = W.T @ V
    comp = V - W @ c
    comp = comp - W @ (W.T @ comp)
    return comp / noise + W @ (d_rng[:, None] * c)


def cg(matvec: Callable, B: torch.Tensor, max_iters: int, tol: float,
       precond: Callable, diverge: float = 4.0, exhaust: int = 25,
       stop_rel: Optional[float] = None):
    """Batched preconditioned CG on A X = B, every column at once, with the
    finite-precision freezes of the method (a column stops when pᵀAp ≤ 0,
    rᵀP⁻¹r ≤ 0, its residual norm falls below ``tol``, or it bounces above
    ``diverge``·its best residual for ``exhaust`` iterations in a row after
    reaching 1% of ‖b‖). With ``stop_rel`` the run ends once every column's
    best relative residual is below it (read every 10 iterations). Returns
    (best iterates, alphas, betas, best residual norms)."""
    n, r = B.shape
    X = torch.zeros_like(B)
    R = B
    Z = precond(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    b_norm = torch.linalg.norm(B, dim=0)
    done = torch.zeros(r, dtype=torch.bool, device=B.device)
    bX, bR = X, b_norm
    stall = torch.zeros(r, dtype=torch.int64, device=B.device)
    alphas = torch.zeros((max_iters, r), dtype=B.dtype, device=B.device)
    betas = torch.zeros_like(alphas)
    for i in range(max_iters):
        AP = matvec(P)
        pAp = torch.sum(P * AP, dim=0)
        bad = (pAp <= 0) | ~torch.isfinite(pAp)
        done_a = done | bad
        alpha = torch.where(done_a, torch.zeros_like(rz),
                            rz / torch.where(pAp > 0, pAp, torch.ones_like(pAp)))
        X = X + alpha * P
        R_new = R - alpha * AP
        Z_new = precond(R_new)
        rz_new = torch.sum(R_new * Z_new, dim=0)
        done = done_a | (rz_new <= 0)
        beta = torch.where(done, torch.zeros_like(rz),
                           rz_new / torch.where(rz > 0, rz, torch.ones_like(rz)))
        P = Z_new + beta * P
        res = torch.linalg.norm(R_new, dim=0)
        better = (res < bR) & torch.isfinite(res) & ~done_a
        bX = torch.where(better[None, :], X, bX)
        bR = torch.where(better, res, bR)
        excursion = (bR < 0.01 * b_norm) & ~(res <= diverge * bR)
        stall = torch.where(excursion, stall + 1, torch.zeros_like(stall))
        done = done | (res < tol) | (stall >= exhaust) | ~torch.isfinite(res)
        R = torch.where(torch.isfinite(R_new), R_new, R)
        Z, rz = Z_new, rz_new
        alphas[i], betas[i] = alpha, beta
        if (stop_rel is not None and i % 10 == 9
                and bool((bR < stop_rel * b_norm).all())):
            break
    return bX, alphas, betas, bR


def slq_logdet(alphas, betas, weights) -> torch.Tensor:
    """Stochastic Lanczos quadrature: mean over probe columns of
    weight·e₁ᵀ log(T) e₁ for the Lanczos tridiagonal T of each column's CG
    run (columns that stopped early get identity rows)."""
    a, b, w = alphas.double(), betas.double(), weights.double()
    one = torch.ones((), dtype=a.dtype, device=a.device)
    safe = torch.where(a != 0, a, one)
    prev = torch.cat([torch.zeros_like(a[:1]), b[:-1] / safe[:-1]], dim=0)
    diag = 1.0 / safe + prev
    off = torch.sqrt(torch.clamp_min(b, 0.0)) / safe
    dead = (a == 0) | ~torch.isfinite(a) | ~torch.isfinite(b)
    diag = torch.where(dead | ~torch.isfinite(diag), one, diag)
    off = torch.where(dead | ~torch.isfinite(off), torch.zeros_like(off), off)[:-1]
    T = (torch.diag_embed(diag.T) + torch.diag_embed(off.T, offset=1)
         + torch.diag_embed(off.T, offset=-1))
    ev, vec = torch.linalg.eigh(T)
    ev = torch.clamp_min(ev, 1e-300)
    return torch.mean(w * torch.sum(vec[:, 0, :] ** 2 * torch.log(ev), dim=-1))


# --- the stochastic NLL, its gradient and Adam -------------------------------

def gram_vjp(desc, leaves, x, U, W, block: int = 1024) -> List[torch.Tensor]:
    """∂/∂θ Σᵢⱼ (UWᵀ)ᵢⱼ K(x, x)ᵢⱼ for the parameter leaves (which require
    grad), by autograd over blocks of rows."""
    grads = [torch.zeros_like(t) for t in leaves]
    p = unflatten(desc, leaves)
    for s in range(0, x.shape[0], block):
        e = min(s + block, x.shape[0])
        with torch.enable_grad():
            k = kernel_value(desc, p, x[s:e], x)
            total = torch.sum((U[s:e] @ W.T) * k)
            gs = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [g + (d if d is not None else 0.0) for g, d in zip(grads, gs)]
    return grads


def nll_and_grad(desc_k, desc_m, pk, pm, noise, x, y, u, w, W_b, sv,
                 max_iters, tol, dtype, block: int = 2048):
    """(nll, kernel grads, noise grad, mean grads, relative residuals) of
    the stochastic NLL estimate at (pk, pm, noise) for the probe draws u
    [n, s], w [m, s] and the preconditioner basis W_b [n, m] with singular
    values sv (P = σ²I + W_b·diag(sv²)·W_bᵀ), computed in ``dtype``:

    probes z = σu + W_b·diag(sv)·w ~ N(0, P); one CG run on [y − m(x) | z];
    the NLL ½yᵀα + ½(log|P| + SLQ) + ½n·log 2π; the gradient from the
    low-rank cotangent ½(Kₙ⁻¹ − ααᵀ) with P⁻¹ as its control variate."""
    f = dict(dtype=dtype, device=x.device)
    xd, yd = x.to(dtype), y.to(dtype)
    noise = torch.as_tensor(noise).to(**f)
    kl = [t.to(**f) for t in flatten(desc_k, pk)]
    ml = [t.to(**f).requires_grad_(True) for t in flatten(desc_m, pm)]
    pkd = unflatten(desc_k, kl)
    with torch.enable_grad():
        m_x = mean_value(desc_m, unflatten(desc_m, ml), xd)
    resid_y = yd - m_x.detach()
    n, s = u.shape
    m = W_b.shape[1]
    Wb, svd = W_b.to(**f), sv.to(**f)
    d_rng = 1.0 / (svd * svd + noise)

    def pinv(V):
        return apply_p_inv(Wb, d_rng, noise, V)

    log_p = (n - m) * torch.log(noise) + torch.sum(torch.log(svd * svd + noise))
    z = torch.sqrt(noise) * u.to(**f) + Wb @ (svd[:, None] * w.to(**f))
    zt = pinv(z)
    z_weights = torch.sum(z * zt, dim=0)
    gram = SymGram(desc_k, pkd, xd, dtype, block)
    B = torch.cat([resid_y[:, None], z], dim=1)
    X, al, be, bR = cg(lambda V: gram.matvec(V) + noise * V, B, max_iters,
                       tol, pinv)
    gram.free()
    rel = bR / torch.clamp_min(torch.linalg.norm(B, dim=0),
                               torch.finfo(dtype).tiny)
    alpha, zhat = X[:, 0], X[:, 1:]
    data_fit = resid_y @ alpha
    G = Wb * torch.sqrt(svd * svd / (noise * (svd * svd + noise)))[None, :]
    rhat = zhat - zt
    U = torch.cat([rhat / (4.0 * s), zt / (4.0 * s), -0.5 * G,
                   -0.5 * alpha[:, None]], dim=1)
    Wc = torch.cat([zt, rhat, G, alpha[:, None]], dim=1)
    trace_est = (n / noise - torch.sum(G * G)
                 + torch.mean(torch.sum(zt * rhat, dim=0)))
    g_noise = 0.5 * (trace_est - alpha @ alpha)
    leaves = [t.detach().requires_grad_(True) for t in kl]
    g_k = gram_vjp(desc_k, leaves, xd, U, Wc)
    with torch.enable_grad():
        tr = torch.sum(kernel_diag(desc_k, unflatten(desc_k, leaves), xd)) / (
            2.0 * noise)
        g_diag = torch.autograd.grad(tr, leaves, allow_unused=True)
        g_m = (torch.autograd.grad(m_x, ml, grad_outputs=-alpha,
                                   allow_unused=True) if ml else [])
    g_k = [a + (b if b is not None else 0.0) for a, b in zip(g_k, g_diag)]
    g_m = [g if g is not None else torch.zeros_like(t) for g, t in zip(g_m, ml)]
    logdet = log_p.double() + slq_logdet(al[:, 1:], be[:, 1:], z_weights)
    nll = 0.5 * data_fit.double() + 0.5 * logdet + 0.5 * n * LOG_2PI
    return nll, g_k, g_noise, g_m, rel


def _median(v: torch.Tensor) -> torch.Tensor:
    return torch.quantile(v.double(), 0.5)


def follow_fit(desc_k, desc_m, x, y, draws, bases, steps: int, lr: float,
               init_noise: float, max_iters: int, tol: float,
               resid_guard: float, dtype, defer=None):
    """Adam (β 0.9 / 0.999, ε 1e-8) over the stochastic NLL for ``steps``
    steps from the stated starting point, the kernel's positive parameters
    and the noise in log space. ``draws[k]`` = (u, w) and ``bases[k]`` =
    (W_b, sv) of step k. A step whose NLL or gradient is not finite, or
    whose median relative CG residual is above ``resid_guard``, is skipped:
    its gradient counts as zero and the parameters stay.

    ``defer`` = (medians, skips, band) of another run of the same steps:
    where its median and this one lie on opposite sides of ``resid_guard``
    and within ``band`` of each other, step k takes that run's decision
    ``skips[k]`` (float32 and float64 resolve such a threshold differently).

    Returns a dict: "nll" per step; "first_grads", the first step's
    gradient in optimiser space per leaf as the optimiser gets it, and
    "first_raw", the same before the skip rule; "u0" and "u", the
    optimiser-space parameters before and after the steps; per step the
    "resid_median", whether everything was "finite", and whether it was
    "skipped"."""
    xmin = x.min(dim=0).values.cpu().numpy()
    xmax = x.max(dim=0).values.cpu().numpy()
    pk0 = default_params(desc_k, xmin, xmax)
    pm0 = default_params(desc_m, xmin, xmax)
    spec = ([("kernel." + p, pos) for p, pos in param_specs(desc_k)]
            + [("log_noise", True)]
            + [("mean." + p, pos) for p, pos in param_specs(desc_m)])
    f = dict(dtype=dtype, device=x.device)
    vals = ([t.to(**f) for t in flatten(desc_k, pk0)]
            + [torch.as_tensor(init_noise, **f)]
            + [t.to(**f) for t in flatten(desc_m, pm0)])
    u = [torch.log(v) if pos else v.clone() for v, (_, pos) in zip(vals, spec)]
    out = {"nll": [], "first_grads": None, "first_raw": None,
           "u0": [t.clone() for t in u], "resid_median": [], "finite": [],
           "skipped": []}
    nk = len(param_specs(desc_k))
    m1 = [torch.zeros_like(t) for t in u]
    m2 = [torch.zeros_like(t) for t in u]
    for k in range(steps):
        cons = [torch.exp(t) if pos else t for t, (_, pos) in zip(u, spec)]
        pk = unflatten(desc_k, cons[:nk])
        noise = cons[nk]
        pm = unflatten(desc_m, cons[nk + 1:])
        nll, g_k, g_n, g_m, rel = nll_and_grad(
            desc_k, desc_m, pk, pm, noise, x, y, draws[k][0], draws[k][1],
            bases[k][0], bases[k][1], max_iters, tol, dtype)
        g = list(g_k) + [g_n] + list(g_m)
        g = [gi * ci if pos else gi for gi, ci, (_, pos) in zip(g, cons, spec)]
        finite = (all(bool(torch.isfinite(t).all()) for t in g)
                  and bool(torch.isfinite(nll))
                  and bool(torch.isfinite(rel).all()))
        med = float(_median(rel))
        bad = not finite or not med <= resid_guard
        if defer is not None and finite:
            other, skips, band = defer[0][k], defer[1][k], defer[2]
            if ((other <= resid_guard) != (med <= resid_guard)
                    and abs(other - med) <= band):
                bad = bool(skips)
        if out["first_raw"] is None:
            out["first_raw"] = [t.clone() for t in g]
        if bad:
            g = [torch.zeros_like(t) for t in g]
        if out["first_grads"] is None:
            out["first_grads"] = [t.clone() for t in g]
        out["nll"].append(float(nll))
        out["resid_median"].append(med)
        out["finite"].append(finite)
        out["skipped"].append(bad)
        t = k + 1
        new = []
        for i, (ui, gi) in enumerate(zip(u, g)):
            m1[i] = 0.9 * m1[i] + 0.1 * gi
            m2[i] = 0.999 * m2[i] + 0.001 * gi * gi
            denom = torch.sqrt(m2[i]) / math.sqrt(1 - 0.999 ** t) + 1e-8
            new.append(ui - (lr / (1 - 0.9 ** t)) * m1[i] / denom)
        if not bad:
            u = new
    out["u"] = u
    return out


# --- the posterior -----------------------------------------------------------

def posterior(desc_k, desc_m, pk, pm, noise, x, y, xt, dtype, rank: int = 256,
              max_iters: int = 200, rtol: float = 1e-10, block: int = 2048):
    """Exact posterior (μ, var) at xt by one preconditioned CG solve of
    Kₙ[α | V] = [y − m(x) | K(x, xt)] in ``dtype``, run until every
    column's relative residual is below ``rtol`` or ``max_iters``: μ =
    m(xt) + K(x, xt)ᵀα, var = k(xt, xt) − Σ K(x, xt)∘V. ``noise`` is the
    whole diagonal term of Kₙ. The preconditioner is its own rank-``rank``
    greedy pivoted Cholesky factor. Returns (μ, var, relative residual per
    column)."""
    f = dict(dtype=dtype, device=x.device)
    xd, yd, xtd = x.to(dtype), y.to(dtype), xt.to(dtype)
    pkd = tree_to(pk, **f)
    pmd = tree_to(pm, **f)
    noise = torch.as_tensor(noise).to(**f)
    with torch.no_grad():
        L = pivoted_cholesky(desc_k, pkd, xd, rank, torch.finfo(dtype).eps)
        Q, Rr = torch.linalg.qr(L)
        Ur, sv, _ = torch.linalg.svd(Rr)
        W = Q @ Ur
        d_rng = 1.0 / (sv * sv + noise)
        gram = SymGram(desc_k, pkd, xd, dtype, block)
        Ks = kernel_value(desc_k, pkd, xd, xtd)
        B = torch.cat([(yd - mean_value(desc_m, pmd, xd))[:, None], Ks], dim=1)
        X, _, _, bR = cg(lambda V: gram.matvec(V) + noise * V, B, max_iters,
                         0.0, lambda V: apply_p_inv(W, d_rng, noise, V),
                         exhaust=max_iters, stop_rel=rtol)
        gram.free()
        rel = bR / torch.linalg.norm(B, dim=0)
        mu = mean_value(desc_m, pmd, xtd) + Ks.T @ X[:, 0]
        var = kernel_diag(desc_k, pkd, xtd) - torch.sum(Ks * X[:, 1:], dim=0)
    return mu, var, rel
