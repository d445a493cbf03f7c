"""Hyperparameter fitting: Adam, L-BFGS and SciPy over the NLL or an
approximation objective, with fit() routing.

Counterpart of ``gaussianprocessfundamentals_tpu/fit/fit.py``: ``FitResult``
(``:36``), ``make_nll`` (``:56``, with its ``gram_fn``), ``make_kfold_nll``
(``:94``), ``APPROXIMATIONS``, ``make_approx_nll`` and ``default_inducing``
(``:152-237``), ``bounds_projection`` (``:240``), ``init_uparams``
(``:267``), ``adam_run`` (``:292``), ``lbfgs_run`` (``:315``),
``fit_batch_independent`` (``:367``), ``scipy_run`` (``:435``),
``_fit_iterative_routed`` (``:471``) and ``fit`` (``:556``) with its
routing: the dense Cholesky NLL (or an O(nm²) approximation objective)
below ``_AUTO_ITERATIVE_N`` rows, the matrix-free iterative NLL
(:func:`..models.iterative.fit_iterative`) from there on or whenever the
dense working set would not fit ``config.dense_hbm_budget``, and ×10
jitter escalation when the NLL comes out non-finite.

The optimisers work on a tree of unconstrained leaf tensors
(``{"kernel": …, "mean": …, "log_noise": …}``) and install the constrained
values in the kernel and mean modules for every evaluation; the fitted
values stay installed when ``fit`` returns. ``adam_run`` is
``torch.optim.Adam``, the update rule of ``optax.adam``; ``lbfgs_run`` is
``torch.optim.LBFGS`` with a strong-Wolfe line search, which reaches the
JAX package's optimum by another path (its zoom line search differs step
by step). Restarts run one after another.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from gaussianprocessfundamentals_tpu_torch.config import DEFAULT_CONFIG, GPConfig
from gaussianprocessfundamentals_tpu_torch.fit.transforms import (
    assign_leaves,
    clip_to_bounds,
    constrain,
    leaf_copy,
    unconstrain,
)
from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
from gaussianprocessfundamentals_tpu_torch.means.functions import (
    MeanFunction,
    ZeroMean,
)
from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

_AUTO_ITERATIVE_N = 8000  # fit(method="auto") dense→iterative crossover

APPROXIMATIONS = ("nystroem", "skc_lower", "skc_upper", "ski")


@dataclasses.dataclass
class FitResult:
    """Fitted parameters (trees of tensors), the noise, and the NLL before
    and after the fit."""

    kernel_params: Any
    mean_params: Any
    noise: torch.Tensor
    nll_pre: float
    nll_post: float
    history: Optional[torch.Tensor] = None
    restart_losses: Optional[torch.Tensor] = None
    # the fitted inducing inputs [m, d] of an approximation objective
    inducing: Optional[torch.Tensor] = None
    # iterative route: {"frozen_frac": share of steps the guard skipped}
    diagnostics: Optional[dict] = None


def _install(kernel, mean, u, optimize_noise, fixed_noise, like):
    """Install the constrained values of ``u`` in the modules; returns the
    noise. The installed tensors keep their graph to ``u``'s leaves."""
    kernel.set_params(constrain(kernel.positivity(), u["kernel"]))
    mean.set_params(constrain(mean.positivity(), u["mean"]))
    if optimize_noise:
        return torch.exp(u["log_noise"])
    return torch.as_tensor(fixed_noise, dtype=like.dtype, device=like.device)


def _gram_of(kernel, gram_fn):
    """The Gram function of an objective: ``gram_fn(kernel, x1, x2)`` reading
    the kernel's installed hyperparameters (e.g. K5,
    ``lambda k, a, b: se_gram(a, b, k.lengthscale)``), else ``kernel.gram``
    under autograd."""
    if gram_fn is None:
        return kernel.gram
    return lambda x1, x2: gram_fn(kernel, x1, x2)


def make_nll(kernel, mean: MeanFunction, x, y,
             config: GPConfig = DEFAULT_CONFIG, optimize_noise: bool = False,
             fixed_noise: float = 0.0, gram_fn=None) -> Callable:
    """``nll(u) -> scalar`` over the unconstrained tree ``u``: the dense
    Cholesky NLL of y − m(x) under K + (σ² + jitter)·I. Batched
    (instance-stacked) problems average, as the JAX package's do.
    ``gram_fn(kernel, x1, x2)`` replaces ``kernel.gram``; a forward-only
    kernel there (K5, K6) evaluates the NLL but raises under a gradient,
    as the JAX package's Pallas ``gram_fn`` does."""
    gram = _gram_of(kernel, gram_fn)

    def nll_fn(u):
        noise = _install(kernel, mean, u, optimize_noise, fixed_noise, x)
        resid = y - mean.mean(x)
        out = chol.nll(gram(x, x), resid, noise, config.jitter)
        return out.mean() if out.ndim else out

    return nll_fn


def make_stacked_nll(kernel, mean: MeanFunction, x, y,
                     config: GPConfig = DEFAULT_CONFIG,
                     optimize_noise: bool = False,
                     fixed_noise: float = 0.0) -> Callable:
    """``nll(u) -> [C]``: :func:`make_nll` of C parameter sets at once, over
    a stacked unconstrained tree ``u`` (every leaf [C, ...]; the MCMC
    chains' positions). The C Grams of x [n, d] come from
    :func:`..models.segmented.stacked_gram`, each differentiable from its
    own slice, and the C NLLs are one batched Cholesky with noise [C];
    the jitter floor is per Gram, so the C sets do not couple. The modules'
    installed parameters come back after each call."""
    from gaussianprocessfundamentals_tpu_torch.models.segmented import (
        _stacked,
        stacked_gram,
    )

    kpos, mpos = kernel.positivity(), mean.positivity()

    def nll_fn(u):
        C = tree_leaves(u["kernel"])[0].shape[0]
        xs = x.expand(C, *x.shape)
        K = stacked_gram(kernel, constrain(kpos, u["kernel"]), xs)
        m = _stacked(mean, constrain(mpos, u["mean"]), mean.mean, xs)
        noise = (torch.exp(u["log_noise"]) if optimize_noise
                 else torch.full((C,), fixed_noise, dtype=x.dtype,
                                 device=x.device))
        return chol.nll(K, y - m, noise, config.jitter)

    return nll_fn


def make_kfold_nll(kernel, mean: MeanFunction, x, y, k: int, perm,
                   config: GPConfig = DEFAULT_CONFIG,
                   optimize_noise: bool = False, fixed_noise: float = 0.0,
                   gram_fn=None) -> Callable:
    """The k-fold objective: the mean over folds of the NLL on each fold's
    training rows, one shared hyperparameter set. The Gram is built once
    per call; the k fold NLLs are one batched masked Cholesky over
    [k, n, n] (held-out rows decoupled, :func:`..models.segmented.
    masked_nll`). The split is :func:`..objectives.metrics.kfold_indices`
    of ``perm``, a permutation of the n rows (where the JAX package takes a
    key)."""
    from gaussianprocessfundamentals_tpu_torch.models.segmented import (
        masked_nll,
    )
    from gaussianprocessfundamentals_tpu_torch.objectives.metrics import (
        kfold_indices,
    )

    n = x.shape[0]
    masks = torch.ones((k, n), dtype=x.dtype, device=x.device)
    for i, (_, test_idx) in enumerate(kfold_indices(n, k, perm)):
        masks[i, torch.as_tensor(test_idx, device=x.device)] = 0.0
    gram = _gram_of(kernel, gram_fn)

    def nll_fn(u):
        noise = _install(kernel, mean, u, optimize_noise, fixed_noise, x)
        resid = y - mean.mean(x)
        return masked_nll(gram(x, x), resid, masks, noise, config.jitter).mean()

    return nll_fn


def make_approx_nll(kernel, mean: MeanFunction, x, y, approximation: str,
                    z, config: GPConfig = DEFAULT_CONFIG,
                    optimize_noise: bool = False, fixed_noise: float = 0.0,
                    optimize_inducing: bool = False,
                    skc_iters: int = 10) -> Callable:
    """``nll(u) -> scalar`` with the covariance replaced by an O(nm²)
    approximation (one of :data:`APPROXIMATIONS`) with inducing inputs z
    [m, d]; with ``optimize_inducing`` the inducing inputs are
    ``u["inducing"]``, optimised with the hyperparameters (continuous
    locations, where the reference trains inducing indices). SKI keeps its
    interpolation grid fixed."""
    from gaussianprocessfundamentals_tpu_torch.linalg.nystroem import (
        nystroem_nll,
    )
    from gaussianprocessfundamentals_tpu_torch.linalg.ski import ski_mll
    from gaussianprocessfundamentals_tpu_torch.objectives.skc import (
        skc_lower_bound,
        skc_upper_bound,
    )

    if approximation not in APPROXIMATIONS:
        raise ValueError(f"unknown approximation {approximation!r}; one of "
                         f"{APPROXIMATIONS}")
    if optimize_inducing and approximation == "ski":
        raise ValueError("SKI uses a fixed interpolation grid; "
                         "optimize_inducing is not supported")
    z = torch.as_tensor(z, dtype=x.dtype, device=x.device)

    def nll_fn(u):
        noise = _install(kernel, mean, u, optimize_noise, fixed_noise, x)
        resid = y - mean.mean(x)
        zz = u["inducing"] if optimize_inducing else z
        if approximation == "nystroem":
            return nystroem_nll(kernel, x, resid, zz, noise, config.jitter)
        if approximation == "skc_lower":
            return -skc_lower_bound(kernel, x, resid, zz, noise,
                                    config.jitter)
        if approximation == "skc_upper":
            return -skc_upper_bound(kernel, x, resid, zz, noise,
                                    config.jitter, num_iters=skc_iters)
        return -ski_mll(kernel, x, resid, zz, noise, config.jitter)

    return nll_fn


def default_inducing(x, m: int, approximation: str = "nystroem"):
    """Initial inducing inputs: rows of x at the rounded, deduplicated
    ``linspace(0, n−1, m)`` (the reference's linspace indices); for SKI at
    d = 1 an equispaced grid over x's range, which its ``searchsorted``
    interpolation needs sorted."""
    n = x.shape[0]
    m = min(m, n)
    if approximation == "ski" and x.shape[-1] == 1:
        lo, hi = float(x[:, 0].min()), float(x[:, 0].max())
        return torch.linspace(lo, hi, m, dtype=x.dtype,
                              device=x.device)[:, None]
    idx = np.unique(np.linspace(0, n - 1, m).round().astype(int))
    return x[torch.as_tensor(idx, device=x.device)]


def bounds_projection(kernel, xrange, n: int) -> Callable:
    """A projection of the unconstrained tree into the kernel's box bounds
    (clipped in log space for positive parameters), over nested operator
    trees too. Mean and noise entries are untouched, as in the JAX
    package."""
    lo, hi = kernel.bounds(xrange, n)
    kpos = kernel.positivity()

    def to_u(b, p):
        b = np.asarray(b, np.float64)
        with np.errstate(divide="ignore"):
            return np.log(b) if p else b

    lo_u = tree_map(to_u, lo, kpos)
    hi_u = tree_map(to_u, hi, kpos)

    def project(u):
        return {**u, "kernel": clip_to_bounds(u["kernel"], lo_u, hi_u)}

    return project


def init_uparams(kernel, mean: MeanFunction, xrange, n: int, generator=None,
                 dtype=None, optimize_noise: bool = False,
                 init_noise: float = 1e-4, device=None):
    """The unconstrained starting tree: the modules' defaults, or random
    points inside the bounds drawn from ``generator``."""
    to = lambda t: t.to(device)  # noqa: E731
    kp = tree_map(to, kernel.init_params(xrange, n, generator, dtype))
    mp = tree_map(to, mean.init_params(xrange, n, generator, dtype))
    u = {"kernel": unconstrain(kernel.positivity(), kp),
         "mean": unconstrain(mean.positivity(), mp)}
    if optimize_noise:
        u["log_noise"] = torch.log(torch.as_tensor(init_noise, dtype=dtype,
                                                   device=device))
    return u


def adam_run(nll_fn, u0, steps: int = 300, lr: float = 0.05,
             project_fn=None):
    """Adam; returns (final unconstrained tree, per-step loss history).
    ``project_fn`` (e.g. :func:`bounds_projection`) is applied after every
    update: projected gradient descent over the box bounds."""
    u = leaf_copy(u0, project_fn)
    opt = torch.optim.Adam(tree_leaves(u), lr=lr)
    hist = []
    for _ in range(steps):
        opt.zero_grad()
        loss = nll_fn(u)
        loss.backward()
        opt.step()
        if project_fn is not None:
            assign_leaves(u, project_fn(u))
        hist.append(loss.detach())
    return tree_map(torch.Tensor.detach, u), torch.stack(hist)


def lbfgs_run(nll_fn, u0, max_iters: int = 200, tol: float = 1e-8,
              project_fn=None):
    """L-BFGS (history 10, strong-Wolfe line search), one iteration per
    ``step`` so the projection and the guards act between iterations.

    Stops after ``max_iters`` iterations, when the gradient's 2-norm at
    the current point is ≤ ``tol``, when an iteration moves nothing, or
    when it makes the parameters non-finite (that iteration is undone).
    A trial point whose NLL is not finite (a Cholesky that failed) is
    reported to the line search as +inf with a NaN gradient, so it
    backtracks by bisection, as the JAX package's zoom search does; torch's
    strong-Wolfe search reads a NaN loss as no failed decrease test and
    extrapolates, off to infinite parameters.
    Returns (final unconstrained tree, None)."""
    u = leaf_copy(u0, project_fn)
    leaves = tree_leaves(u)
    # max_eval bounds the line search too (max_ls = max_eval − 1): torch's
    # default for max_iter=1 is 1, which would leave it no trial steps
    opt = torch.optim.LBFGS(leaves, lr=1.0, max_iter=1, max_eval=26,
                            history_size=10, tolerance_grad=0.0,
                            line_search_fn="strong_wolfe")
    evals = []

    def closure():
        opt.zero_grad()
        loss = nll_fn(u)
        loss.backward()
        if not bool(torch.isfinite(loss)):
            # +inf fails the decrease test; the NaN slope makes the
            # search's cubic step fall back to bisection
            for p in leaves:
                if p.grad is not None:
                    p.grad.fill_(float("nan"))
            loss = torch.full_like(loss.detach(), float("inf"))
        gnorm = torch.sqrt(sum(torch.sum(p.grad * p.grad) for p in leaves
                               if p.grad is not None))
        evals.append((float(loss.detach()), float(gnorm)))
        return loss

    for _ in range(max_iters):
        before = [p.detach().clone() for p in leaves]
        evals.clear()
        opt.step(closure)
        loss0, gnorm0 = evals[0]  # at the point this iteration started
        if project_fn is not None:
            assign_leaves(u, project_fn(u))
        if not all(bool(torch.isfinite(p).all()) for p in leaves):
            assign_leaves(u, before)
            break
        moved = any(bool((p != b).any()) for p, b in zip(leaves, before))
        if not np.isfinite(loss0) or gnorm0 <= tol or not moved:
            break
    return tree_map(torch.Tensor.detach, u), None


def scipy_run(nll_fn, u0, method: str = "BFGS", max_iters: int = 500):
    """SciPy's ``minimize`` (``method`` "BFGS", "CG", ...) over the
    unconstrained tree flattened to one float64 vector; the value and
    gradient come from ``nll_fn`` under autograd, in the tree's dtype and
    device. A non-finite value is reported as (1e30, 0), so the line search
    backs off. Returns (final tree, None)."""
    import scipy.optimize

    leaves = tree_leaves(u0)
    like = leaves[0]
    sizes = [t.numel() for t in leaves]

    def unravel(flat):
        parts = torch.split(flat, sizes)
        return tree_unflatten(u0, [p.reshape(t.shape)
                                   for p, t in zip(parts, leaves)])

    def fun(uf):
        flat = torch.as_tensor(uf, dtype=like.dtype,
                               device=like.device).requires_grad_(True)
        v = nll_fn(unravel(flat))
        (g,) = torch.autograd.grad(v, flat, allow_unused=True)
        g = (np.zeros(flat.shape[0]) if g is None
             else g.detach().cpu().numpy().astype(np.float64))
        v = float(v.detach())
        if not np.isfinite(v):
            return 1e30, np.zeros_like(g)
        return v, g

    flat0 = torch.cat([t.detach().reshape(-1) for t in leaves])
    res = scipy.optimize.minimize(
        fun, flat0.cpu().numpy().astype(np.float64), jac=True, method=method,
        options={"maxiter": max_iters},
    )
    return unravel(torch.as_tensor(res.x, dtype=like.dtype,
                                   device=like.device)), None


def fit_batch_independent(kernel, xb, yb, mean: Optional[MeanFunction] = None,
                          config: GPConfig = DEFAULT_CONFIG, steps: int = 300,
                          lr: float = 0.05, optimize_noise: bool = True,
                          noise: float = 1e-4, generator=None):
    """Fit b independent GP problems xb [b, n, d], yb [b, n], each with its
    own hyperparameters, as one batched Adam program
    (:func:`..models.segmented.adam_stacked`: stacked Grams, one batched
    Cholesky, one Adam over the stacked parameters). Each instance starts
    from the defaults for its own x-range, or from a random point inside
    the bounds drawn from ``generator``. Returns (kernel params stacked on
    a leading axis b, noises [b], the NLLs [b] of the last step, before its
    update)."""
    from gaussianprocessfundamentals_tpu_torch.models.segmented import (
        adam_stacked,
    )

    b, n, d = xb.shape
    mean = mean if mean is not None else ZeroMean(dim=d)
    inits = []
    for i in range(b):
        xr = torch.stack([xb[i].min(dim=0).values, xb[i].max(dim=0).values],
                         dim=-1).cpu().numpy()
        inits.append(init_uparams(kernel, mean, xr, n, generator, xb.dtype,
                                  optimize_noise, max(noise, 1e-6),
                                  xb.device))
    fixed_noise = torch.full((b,), noise, dtype=xb.dtype, device=xb.device)
    u, final = adam_stacked(kernel, xb, yb, torch.ones_like(yb), inits, steps,
                            lr, optimize_noise, fixed_noise, config.jitter,
                            mean=mean)
    kp = constrain(kernel.positivity(), u["kernel"])
    noises = torch.exp(u["log_noise"]) if optimize_noise else fixed_noise
    return kp, noises, final


def iterative_fit_result(out, with_mean: bool) -> FitResult:
    """The FitResult of :func:`..models.iterative.fit_iterative`'s return
    with diagnostics; nll_pre and nll_post are the stochastic estimates of
    the first and last steps."""
    if with_mean:
        kp, mp, noise, hist, diag = out
    else:
        (kp, noise, hist, diag), mp = out, {}
    return FitResult(kp, mp, noise, nll_pre=float(hist[0]),
                     nll_post=float(hist[-1]), history=hist, diagnostics=diag)


def _fit_iterative_routed(kernel, x, y, generator, steps, lr, restarts,
                          optimize_noise, noise, xrange,
                          iterative_kwargs=None, mean=None,
                          enforce_bounds: bool = False) -> FitResult:
    """fit()'s large-n route: Adam over the mBCG + SLQ iterative NLL
    (:func:`..models.iterative.fit_iterative`), with the median-residual
    step guard at 0.5 unless ``iterative_kwargs`` says otherwise. A
    ``mesh`` in ``iterative_kwargs`` shards the products over its ranks;
    restarts then run here one after another (``fit_iterative`` refuses
    them under a mesh), each from fit_iterative's own restart point and
    probe stream, the best final NLL winning, NaN-safe."""
    from gaussianprocessfundamentals_tpu_torch.models.iterative import (
        fit_iterative,
    )

    kw = dict(resid_guard=0.5)
    kw.update(iterative_kwargs or {})
    # clamp the noise only where it is an optimiser start; a fixed noise is
    # solved as given (fit() keeps fixed noise < 1e-6 off this route)
    init_noise = max(float(noise), 1e-6) if optimize_noise else float(noise)
    if type(mean) is ZeroMean:
        mean = None  # contributes nothing; keep the lean path
    common = dict(steps=steps, lr=lr, optimize_noise=optimize_noise,
                  init_noise=init_noise, xrange=xrange, mean=mean,
                  enforce_bounds=enforce_bounds, return_diagnostics=True, **kw)
    if kw.get("mesh") is None or restarts == 0:
        out = fit_iterative(kernel, x, y, generator, restarts=restarts,
                            **common)
        return iterative_fit_result(out, mean is not None)
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    probe_state = generator.get_state()
    best = None
    for i in range(restarts + 1):
        g_init = (common.pop("init_generator", None) if i == 0 else
                  torch.Generator().manual_seed(
                      generator.initial_seed() + 0xA110 + i))
        generator.set_state(probe_state)
        res = iterative_fit_result(
            fit_iterative(kernel, x, y, generator, init_generator=g_init,
                          **common), mean is not None)
        if best is None or (res.nll_post == res.nll_post
                            and not best.nll_post <= res.nll_post):
            best = res
    kernel.set_params(best.kernel_params)
    if mean is not None:
        mean.set_params(best.mean_params)
    return best


def fit(
    kernel, x, y, mean: Optional[MeanFunction] = None,
    config: GPConfig = DEFAULT_CONFIG, method: str = "lbfgs",
    restarts: int = 0, generator=None, optimize_noise: bool = False,
    noise: float = 1e-4, steps: int = 300, lr: float = 0.05, xrange=None,
    enforce_bounds: bool = False, iterative_kwargs: Optional[dict] = None,
    gram_fn=None, kfold: int = 0, approximation: Optional[str] = None,
    n_inducing: Optional[int] = None, optimize_inducing: bool = False,
) -> FitResult:
    """Fit kernel and mean hyperparameters by minimising the NLL.

    ``method``: "lbfgs", "adam", "scipy-bfgs" or "scipy-cg"
    (:func:`scipy_run`) on the dense NLL, or "auto": the dense L-BFGS route
    below ``_AUTO_ITERATIVE_N`` rows and the matrix-free iterative Adam
    route (``steps``, ``lr``, ``iterative_kwargs``) from there on. "lbfgs"
    and "adam" switch to the iterative route, with a warning, when the
    dense working set ~3·b·n²·itemsize (b instances) exceeds
    ``config.dense_hbm_budget``.
    ``restarts > 0`` adds that many random starts inside the bounds, drawn
    from ``generator`` (required on the dense route), and keeps the best
    final NLL. A non-finite result is retried with the jitter ×10, up to
    ``config.max_jitter_retries`` times. ``enforce_bounds`` projects the
    kernel hyperparameters into ``kernel.bounds(xrange, n)`` after every
    step (SciPy's optimisers are unconstrained: once, at readout).
    ``gram_fn(kernel, x1, x2)`` replaces ``kernel.gram`` in the objective
    (:func:`make_nll`); ``kfold > 1`` fits the mean k-fold NLL
    (:func:`make_kfold_nll`), the split drawn from ``generator``
    (required).

    ``approximation`` (one of :data:`APPROXIMATIONS`) swaps the exact NLL
    for that O(nm²) objective (:func:`make_approx_nll`) with
    ``n_inducing`` inducing inputs (default max(20,
    ⌊config.nystroem_ratio·n⌋), placed by :func:`default_inducing`);
    ``optimize_inducing`` optimises their locations too (it does nothing
    without an approximation, as in the JAX package). An approximation
    needs no [n, n] working set, so the budget does not apply to it.
    Approximations, the k-fold objective and a custom ``gram_fn`` keep the
    fit off the iterative route.

    Batched (instance-stacked) input, x [..., n, d] and y [..., n], fits
    one parameter set shared by the instances to the mean of their NLLs
    on the dense route (its working set counts every instance); without
    ``xrange`` the x-range is taken over every row of every instance. The
    k-fold and approximation objectives take one instance only.
    """
    methods = ("auto", "lbfgs", "adam", "scipy-bfgs", "scipy-cg")
    if method not in methods:
        raise ValueError(f"fit(method={method!r}): one of {methods}")
    mean = mean if mean is not None else ZeroMean(dim=x.shape[-1])
    batched = x.ndim > 2
    if batched and (kfold > 1 or approximation is not None
                    or optimize_inducing):
        raise ValueError(
            "fit(): the k-fold and approximation objectives take one "
            f"instance, x [n, d]; got batched input of shape {tuple(x.shape)}")
    if xrange is None:
        rows = x.reshape(-1, x.shape[-1])
        xrange = torch.stack([rows.min(dim=0).values, rows.max(dim=0).values],
                             dim=-1).cpu().numpy()
    n = x.shape[-2]
    batch = int(np.prod(x.shape[:-2]))
    dtype = x.dtype
    # the iterative route would have to clamp a fixed noise this small,
    # silently solving another model; it has no k-fold or approximation
    # objective and no Gram function but its own
    blockers = [name for name, given in (
        ("an approximation objective", approximation is not None),
        ("optimize_inducing", optimize_inducing),
        ("a fixed noise < 1e-6", not optimize_noise and float(noise) < 1e-6),
        ("the k-fold objective", kfold > 1),
        ("a custom gram_fn", gram_fn is not None),
        ("batched (instance-stacked) input", batched)) if given]
    iterative_ok = not blockers
    if kfold > 1 and generator is None:
        raise ValueError("fit(kfold>1) needs a generator for the fold split")
    # the k-fold objective holds one more [n, n] per fold, and a batch one
    # working set per instance
    dense_bytes = ((3 + (kfold if kfold > 1 else 0)) * batch * n * n
                   * x.element_size())
    dense_feasible = (approximation is not None
                      or dense_bytes <= config.dense_hbm_budget)
    route_iterative = False
    if method == "auto":
        route_iterative = iterative_ok and (
            n >= _AUTO_ITERATIVE_N or not dense_feasible)
        if not route_iterative:
            method = "lbfgs"
    if not dense_feasible and not route_iterative:
        if not iterative_ok or method not in ("lbfgs", "adam"):
            raise ValueError(
                f"fit(method={method!r}) at n={n} needs a dense working set "
                f"of ~{dense_bytes / 1e9:.1f} GB (> budget "
                f"{config.dense_hbm_budget / 1e9:.1f} GB, "
                f"config.dense_hbm_budget), and "
                f"{', '.join(blockers or [f'method={method!r}'])} keeps it "
                "off the matrix-free iterative route. Reduce n, optimise the "
                "noise, use an approximation objective, or raise "
                "config.dense_hbm_budget if the memory truly exists."
            )
        warnings.warn(
            f"fit(method={method!r}) at n={n} needs a dense working set of "
            f"~{dense_bytes / 1e9:.1f} GB (> budget "
            f"{config.dense_hbm_budget / 1e9:.1f} GB, "
            "config.dense_hbm_budget); routing to the matrix-free iterative "
            "fitter instead.",
            stacklevel=2,
        )
        route_iterative = True
    if route_iterative:
        return _fit_iterative_routed(
            kernel, x, y, generator, steps, lr, restarts,
            optimize_noise, noise, xrange, iterative_kwargs, mean=mean,
            enforce_bounds=enforce_bounds,
        )
    if restarts > 0 and generator is None:
        raise ValueError("fit(restarts>0) on the dense route needs a generator")
    z0 = None
    if approximation is not None:
        if kfold > 1:
            raise ValueError("approximation objectives do not support kfold")
        m = n_inducing or max(20, int(config.nystroem_ratio * n))
        z0 = default_inducing(x, m, approximation)
    project = bounds_projection(kernel, xrange, n) if enforce_bounds else None
    start = dict(dtype=dtype, optimize_noise=optimize_noise,
                 init_noise=max(noise, 1e-6), device=x.device)
    inits = [init_uparams(kernel, mean, xrange, n, None, **start)]
    inits += [init_uparams(kernel, mean, xrange, n, generator, **start)
              for _ in range(restarts)]
    if optimize_inducing and z0 is not None:
        for u0 in inits:
            u0["inducing"] = z0

    perm = (torch.randperm(n, generator=generator,
                           device=generator.device).cpu()
            if kfold > 1 else None)

    def attempt(cfg: GPConfig) -> FitResult:
        if approximation is not None:
            nll_fn = make_approx_nll(kernel, mean, x, y, approximation, z0,
                                     cfg, optimize_noise, noise,
                                     optimize_inducing)
        elif kfold > 1:
            nll_fn = make_kfold_nll(kernel, mean, x, y, kfold, perm, cfg,
                                    optimize_noise, noise, gram_fn)
        else:
            nll_fn = make_nll(kernel, mean, x, y, cfg, optimize_noise, noise,
                              gram_fn)

        def run(u0):
            if method == "adam":
                return adam_run(nll_fn, u0, steps, lr, project)
            if method == "lbfgs":
                return lbfgs_run(nll_fn, u0, project_fn=project)
            u, hist = scipy_run(nll_fn, u0, "BFGS" if method == "scipy-bfgs"
                                else "CG")
            return (u if project is None else project(u)), hist

        runs = [run(u0) for u0 in inits]
        with torch.no_grad():
            losses = torch.stack([nll_fn(u).detach() for u, _ in runs])
        safe = torch.where(torch.isfinite(losses), losses,
                           torch.full_like(losses, float("inf")))
        best = int(torch.argmin(safe))
        u, hist = runs[best]
        with torch.no_grad():
            nll_pre = float(nll_fn(inits[0]))
            nll_post = float(nll_fn(u))
            fitted_noise = _install(kernel, mean, u, optimize_noise, noise, x)
        return FitResult(
            constrain(kernel.positivity(), u["kernel"]),
            constrain(mean.positivity(), u["mean"]), fitted_noise,
            nll_pre, nll_post, hist,
            losses if restarts > 0 else None,
            inducing=u.get("inducing", z0),
        )

    cfg = config
    for _ in range(config.max_jitter_retries):
        res = attempt(cfg)
        if np.isfinite(res.nll_post):
            return res
        cfg = dataclasses.replace(cfg, jitter=cfg.jitter * 10.0)
    return res
