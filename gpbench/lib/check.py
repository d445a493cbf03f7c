"""Whether what the timed path produced is correct: the program's outputs
against the plain reference (:mod:`gpbench.reference.gp`), number by
number, each against its limit from the configuration file.

Fit cells. Set-up drives the cell's own ``GaussianProcess.fit`` call from
the seed through its first steps; the reference follows those steps from
the same data, the same probe draws and the same starting point, in
float64, with the program's preconditioner basis of each step (its greedy
pivots among near-equal residual diagonals set the probe draws'
directions). The reference takes each step guard's decision by its own
rule, and takes the program's only where the two medians the rule reads
lie on opposite sides of its threshold and within ``guard_gap``'s limit of
each other. The numbers:

* ``nll_gap``: the largest relative gap of the NLL estimate over the steps;
* ``grad_gap``: the first step's gradient, the gap of each leaf's norm
  against the reference's norm of that leaf or of the median leaf,
  whichever is larger; the worst leaf; the larger of the two readings
  before the step guard and as the optimiser gets it;
* ``change_gap``: the same of the change of each leaf after the steps, over
  the leaves whose reference gradient is at least a thousandth of the
  median leaf's;
* ``precond_gap``: at every step, |Σsv² of the program's basis − Σsv² of
  the reference's own rank-m pivoted Cholesky at the parameters the
  program built it at| over tr K there (the shares of K they capture);
  the largest over the steps;
* ``guard_gap``: the largest gap, over the steps, of the median relative CG
  residual the program's guard read against the reference's;
* ``skip_mismatch``: the steps whose skip the program decided otherwise
  than the reference, or otherwise than its own rule applied to what its
  guard read (exact: limit 0).

Posterior cells. A sample of the test points of the window's requests,
drawn from the seed, against the reference's exact posterior at them:

* ``mean_gap``: max |μ − μ_ref| / √k(x*, x*);
* ``var_gap``: max |var − var_ref| / k(x*, x*).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from gpbench.lib.system import generator, seed_for, tensor_tree
from gpbench.reference import gp as ref


def _leaf_norms(ts) -> np.ndarray:
    return np.array([float(torch.linalg.norm(t.detach().double().reshape(-1)))
                     for t in ts])


def _gap_by_leaf(prog, want, keep=None) -> float:
    a, b = _leaf_norms(prog), _leaf_norms(want)
    scale = np.maximum(b, np.median(b))
    gaps = np.abs(a - b) / np.where(scale > 0, scale, 1.0)
    if keep is not None:
        gaps = gaps[keep]
    return float(gaps.max()) if gaps.size else 0.0


def probe_draws(cfg: dict, seed: int, call: int, x: torch.Tensor, steps: int):
    """The probe draws of ``steps`` steps of fit call ``call``, drawn as the
    program draws them from the generator the benchmark hands it."""
    knobs = cfg["fit"]["iterative_kwargs"]
    s, m = cfg["fit"]["num_probes"], min(knobs["precond_m"], x.shape[0])
    g = generator(seed_for(seed, "probes", call), x.device)
    out = []
    for _ in range(steps):
        u = torch.randn((x.shape[0], s), generator=g, dtype=x.dtype,
                        device=x.device)
        w = torch.randn((m, s), generator=g, dtype=x.dtype, device=x.device)
        out.append((u, w))
    return out


def program_u(cfg: dict, res) -> list:
    """The program's fitted parameters in optimiser space (log of the
    positive ones), in the reference's leaf order."""
    dk, dm = cfg["kernel"], cfg["mean"]
    spec = ([pos for _, pos in ref.param_specs(dk)] + [True]
            + [pos for _, pos in ref.param_specs(dm)])
    vals = (ref.flatten(dk, res.kernel_params) + [torch.as_tensor(res.noise)]
            + ref.flatten(dm, res.mean_params))
    return [torch.log(v.double()) if pos else v.double()
            for v, pos in zip(vals, spec)]


def reference_fit(cfg: dict, x, y, seed: int, record: dict,
                  dtype=torch.float64, defer: bool = True) -> dict:
    """The reference following the steps of the recorded set-up fit call in
    ``dtype``, with the program's preconditioner basis of each step; with
    ``defer`` it takes the program's guard decision where the two medians
    straddle the threshold within ``guard_gap``'s limit. Its "sv" holds
    its own singular values at the parameters of each recorded basis."""
    f = cfg["fit"]
    steps = len(record["nll"])
    band = cfg["limits"]["fit"]["guard_gap"]
    out = ref.follow_fit(
        cfg["kernel"], cfg["mean"], x, y, probe_draws(cfg, seed, 0, x, steps),
        [(W, sv) for W, sv, _, _ in record["bases"]], steps, f["lr"],
        f["noise"], f["iterative_kwargs"]["max_iters"],
        f["iterative_kwargs"]["tol"], f["resid_guard"], dtype,
        defer=((record["resid_median"], record["skipped"], band)
               if defer else None))
    out["sv"] = [reference_sv(cfg, x, p, noise, dtype)
                 for _, _, p, noise in record["bases"]]
    return out


def fit_gaps(got: dict, want: dict, resid_guard: float) -> dict:
    """The fit numbers of ``got`` (the program's record, or the control's)
    against ``want`` (the float64 reference): both hold "nll" per step,
    "first_grads" (as the optimiser gets them) and "first_raw" (before the
    step guard), "u" (optimiser-space parameters after the steps), "sv"
    (the preconditioner's singular values at each step), and per step the
    guard's "resid_median", "finite" and "skipped"; ``want`` also "u0" and
    "tr" (tr K at each step's basis parameters)."""
    nll_gap = max(abs(p - r) / abs(r) for p, r in zip(got["nll"], want["nll"]))
    grad_gap = max(_gap_by_leaf(got["first_raw"], want["first_raw"]),
                   _gap_by_leaf(got["first_grads"], want["first_grads"]))
    gn = _leaf_norms(want["first_raw"])
    keep = gn >= 1e-3 * np.median(gn)
    u0 = want["u0"]
    change_gap = _gap_by_leaf([a.double() - b for a, b in zip(got["u"], u0)],
                              [a - b for a, b in zip(want["u"], u0)], keep)
    precond = max(float(abs(torch.sum(sp.double() ** 2)
                            - torch.sum(sr.double() ** 2)) / tr)
                  for sp, sr, tr in zip(got["sv"], want["sv"], want["tr"]))
    guard = max(abs(a - b) for a, b in zip(got["resid_median"],
                                           want["resid_median"]))
    mismatch = sum(
        int(s != r or s != (not ok or not m <= resid_guard))
        for s, r, ok, m in zip(got["skipped"], want["skipped"], got["finite"],
                               got["resid_median"]))
    return {"nll_gap": nll_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "precond_gap": precond,
            "guard_gap": guard, "skip_mismatch": float(mismatch)}


def program_fit(cfg: dict, record: dict) -> dict:
    """The program's side of :func:`fit_gaps` from the recorded call."""
    return {"nll": record["nll"], "first_grads": record["first_grads"],
            "first_raw": record["first_raw"],
            "u": program_u(cfg, record["res"]),
            "sv": [sv for _, sv, _, _ in record["bases"]],
            "resid_median": record["resid_median"],
            "finite": record["finite"], "skipped": record["skipped"]}


def fit_numbers(cfg: dict, x, y, seed: int, record: dict) -> dict:
    """The fit numbers of the recorded set-up call (``record``: see
    ``traffic/kinds/fit.py``). A call whose recorded steps the reference
    cannot follow (a step, a guard reading or a basis missing, a basis not
    of the training set's rows) reads infinite."""
    m = min(cfg["fit"]["iterative_kwargs"]["precond_m"], x.shape[0])
    steps = len(record["nll"])
    if (len(record["bases"]) != steps or len(record["skipped"]) != steps
            or any(tuple(W.shape) != (x.shape[0], m)
                   for W, _, _, _ in record["bases"])):
        return {k: float("inf") for k in cfg["limits"]["fit"]}
    want = reference_fit(cfg, x, y, seed, record)
    want["tr"] = basis_traces(cfg, x, record)
    return fit_gaps(program_fit(cfg, record), want, cfg["fit"]["resid_guard"])


def basis_traces(cfg: dict, x, record: dict) -> list:
    """tr K at the parameters of each recorded basis."""
    return [float(torch.sum(ref.kernel_diag(
        cfg["kernel"], ref.tree_to(p, dtype=torch.float64), x.double())))
        for _, _, p, _ in record["bases"]]


def reference_sv(cfg: dict, x, params, noise, dtype) -> torch.Tensor:
    """Singular values of the reference's own rank-m greedy pivoted
    Cholesky factor at the kernel parameters ``params``, in ``dtype`` with
    the pivot floor of the configuration's float32, after the rule that
    drops directions with sv² ≤ 1e-3·σ²."""
    pk = ref.tree_to(params, dtype=dtype, device=x.device)
    noise = float(noise)
    m = min(cfg["fit"]["iterative_kwargs"]["precond_m"], x.shape[0])
    with torch.no_grad():
        L = ref.pivoted_cholesky(cfg["kernel"], pk, x.to(dtype), m,
                                 torch.finfo(torch.float32).eps)
        sv = torch.linalg.svdvals(torch.linalg.qr(L)[1])
        return torch.where(sv * sv > 1e-3 * noise, sv, torch.zeros_like(sv))


def sample_points(results: list, seed: int, count: int):
    """``count`` test points drawn from the seed among all points of the
    window's requests: (x* [k, d], μ [k], var [k])."""
    xs = torch.cat([r[0] for r in results])
    mus = torch.cat([r[1] for r in results])
    vs = torch.cat([r[2] for r in results])
    rng = np.random.default_rng(seed_for(seed, "check-sample"))
    idx = rng.choice(xs.shape[0], size=min(count, xs.shape[0]), replace=False)
    idx = torch.as_tensor(np.sort(idx), device=xs.device)
    return xs[idx], mus[idx], vs[idx]


def posterior_numbers(cfg: dict, x, y, xt, mu, var, dtype=torch.float64,
                      want=None) -> dict:
    """The posterior numbers of (μ, var) at xt; ``want`` is the reference's
    (μ, var, k(x*, x*)) when already computed."""
    if want is None:
        want = posterior_reference(cfg, x, y, xt, dtype)
    mu_r, var_r, kss = want
    mean_gap = torch.max(torch.abs(mu.double() - mu_r) / torch.sqrt(kss))
    var_gap = torch.max(torch.abs(var.double() - var_r) / kss)
    return {"mean_gap": float(mean_gap), "var_gap": float(var_gap)}


def posterior_reference(cfg: dict, x, y, xt, dtype=torch.float64):
    p = cfg["serve_params"]
    noise = p["noise"] + cfg["jitter"]
    pk = tensor_tree(p["kernel"], x.device, torch.float64)
    mu, var, _ = ref.posterior(cfg["kernel"], cfg["mean"], pk,
                               tensor_tree(p["mean"], x.device, torch.float64),
                               noise, x, y, xt, dtype)
    kss = ref.kernel_diag(cfg["kernel"], pk, xt.double())
    return mu.double(), var.double(), kss


@contextlib.contextmanager
def tf32_matmuls():
    """The lower-precision control's precision: float32 matmuls on TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[1])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]


def verdict(numbers: dict, limits: dict) -> tuple:
    """(all within their limits, {name: {"value", "limit"}})."""
    shown = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, shown
