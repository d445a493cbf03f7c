"""Drive the PyTorch port's serving and training paths once on one GPU.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure raises and exits
non-zero):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions and the TF32 flags (both off: full-float32 matmuls);
2. build: compile both kernels from the checkout, one nvcc for each source,
   started together: Gram·V (K1, csrc/gram_matvec.cu) and the low-rank-
   cotangent gradient (K2, csrc/lowrank_vjp.cu), sm_90a;
3. K1 check: K1 against its plain PyTorch version on the card at ragged
   shapes, for SE, Matérn-3/2 and Matérn-5/2 at d = 1 and SE at d = 3;
   Phase 5 repeats the check at the main path's shapes (n = 100k,
   r = 1 and 256);
4. small-n posterior oracle: the iterative posterior (through K1) against a
   float64 dense Cholesky posterior, n = 4096, 64 test points;
5. serving main path: ``GaussianProcess(...).posterior`` at N = 100,000
   training points and 1,000 test points through ``method="auto"`` (the
   matrix-free chunked mBCG route), with K1's launch count, CG residuals,
   accuracy against the noise-free function, peak device memory, and K1's
   time against the plain version's at the main path's shapes;
6. K2 check: K2 against its plain version on the card at ragged shapes,
   the cases of phase 3 at r = 1, 17, 145 and 273 (relative error per
   scalar ≤ 1e-3), and at n = 65,536 against the plain version run in
   float64 (≤ 3e-3): the JAX package's gates ``fused_lrvjp_*``, whose
   cotangent has mean 0.25·r. Each case again at r = 273 with a zero-mean
   cotangent, whose sums cancel as the fit's do, against the float64
   plain version (≤ 1e-4);
7. small-n fit oracle: one iterative NLL + gradient at n = 4096 on the
   streamed route (K1 and K2), 64 probes, against the float64 dense NLL and
   its gradient;
8. training main path: ``GaussianProcess(...).fit(method="auto")`` at
   N = 100,000 with a constant + linear mean, 10 Adam steps of the JAX
   package's 100k fit story (60 there), then a posterior at 1,000 points;
   K1 and K2 launch counts, NLL history, skipped steps, peak memory;
9. the training path's kernels checked and timed against their plain
   versions at its shapes: K2 at n = 100k, r = 2·8 + 256 + 1 = 273 (both
   cotangents of phase 6), and K1 at the CG width r = 9 (y and 8 probes),
   each beside its bound;
10. profile: the fit of phase 8 again, warm (wall and seconds per step),
    then one fit step under ``torch.profiler``: device time by kernel and
    the device's busy share of the step's wall time.

Each path's launch counts are set to 0 just before it is driven and read
just after. The second-to-last line, after the card's name and power
limit, is one JSON object that lists both kernels: launches on the main
paths (``launches``: the posterior of phase 5 plus the fit of phase 8;
``launches_by_path``: each alone), the largest absolute and relative
differences from the plain version over the checks (relative: K1's
max|diff| / max|ref|, K2's per scalar), the kernel's and the plain
version's times at the main path's shapes, and the bound: the larger of the bytes the function must move over
3.35 TB/s and its operations over their peak (2·n1·n2·(r + d) float32
operations at 67 TFLOP/s; n1·n2 exponentials at 132 SMs × 16 per clock ×
1.98 GHz on the special-function units). The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it fails.
"""
from __future__ import annotations

import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_MAIN = 100_000
T_MAIN = 1_000
NOISE = 1e-2
LENGTHSCALE = 0.1
FIT_STEPS = 10
# the JAX package's 100k fit story (benchmarks/bench_100k_story.py), minus
# its TPU program-size knobs
FIT_KWARGS = dict(method="auto", optimize_noise=True, noise=1e-2, lr=0.05,
                  steps=FIT_STEPS,
                  iterative_kwargs={"max_iters": 25, "precond_m": 256,
                                    "tol": 3e-3, "early_exit": False})
R_MAIN = 2 * 8 + 256 + 1  # K2's rank: 8 probes, m = 256
R_CG = 1 + 8  # K1's width in the fit's CG: y and 8 probes
# K2's limit per scalar against the float64 plain version on a zero-mean
# cotangent, whose sums cancel (the JAX gate's 1e-3 is for one that does not)
K2_RTOL_CANCEL = 1e-4

# peaks of one H100 SXM (NVIDIA's data sheet; the special-function rate is
# the CUDA programming guide's 16 per clock per SM at the 1.98 GHz boost)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
EXP_PER_S = 132 * 16 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"f32_precision={torch.get_float32_matmul_precision()}")
    return smi


def phase_build() -> None:
    """Both kernels, one nvcc each, started together."""
    from gaussianprocessfundamentals_tpu_torch.ops import (
        cuda_build,
        cuda_gram,
        cuda_lrvjp,
    )

    def timed(source):
        t0 = time.perf_counter()
        cuda_build.build(source)
        return time.perf_counter() - t0

    sources = ("gram_matvec.cu", "lowrank_vjp.cu")
    with ThreadPoolExecutor(len(sources)) as pool:
        seconds = list(pool.map(timed, sources))
    cuda_gram._lib()
    cuda_lrvjp._lib()
    for source, dt in zip(sources, seconds):
        log(f"[build] {source} -> {cuda_build.library_path(source).name} "
            f"in {dt:.2f} s")


def phase_kernel_check() -> tuple[float, float]:
    """K1 against its plain version on the card; returns the largest
    absolute and relative differences over every case."""
    g = torch.Generator().manual_seed(1)
    n1, n2 = 3000, 5001
    worst = (0.0, 0.0)
    cases = [("se", 1, 0.1, 1.3, 5e-5), ("mat32", 1, 0.2, 0.7, 5e-5),
             ("mat52", 1, 0.2, 0.7, 5e-5), ("se", 3, 0.4, 1.3, 5e-4)]
    for kind, d, ls, var, rtol in cases:
        x1 = torch.rand(n1, d, generator=g).cuda()
        x2 = torch.rand(n2, d, generator=g).cuda()
        for r in (1, 9, 64, 257):
            V = torch.randn(n2, r, generator=g).cuda()
            worst = _worse(worst, _check_against_plain(x1, x2, V, ls, var,
                                                       kind, rtol))
    return worst


def _worse(a, b):
    """Elementwise max of two (max_abs_err, max_rel_err) pairs."""
    return max(a[0], b[0]), max(a[1], b[1])


def _check_against_plain(x1, x2, V, ls, var, kind, rtol,
                         f64=False) -> tuple[float, float]:
    """K1 against its plain version on the same inputs: max|diff| must be
    within ``rtol`` of max|ref| (the JAX package's on-chip gates: 5e-5 at
    d = 1, 5e-4 at SE d = 3). With ``f64``, also print both versions'
    distance from the plain version run in float64. Returns max|diff| and
    max|diff| / max|ref|."""
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
        fused_gram_matvec_cross,
        plain_gram_matvec_cross,
    )

    got = fused_gram_matvec_cross(x1, x2, V, ls, var, kind)
    torch.cuda.synchronize()
    ref = plain_gram_matvec_cross(x1, x2, V, ls, var, kind)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= rtol * scale
    tag = f"{kind} d={x1.shape[1]} n1={x1.shape[0]} n2={x2.shape[0]} r={V.shape[1]}"
    extra = ""
    if f64:
        ref64 = plain_gram_matvec_cross(x1.double(), x2.double(), V.double(),
                                        ls, var, kind)
        extra = (f"; vs float64: kernel {float((got.double() - ref64).abs().max()):.3e}, "
                 f"plain {float((ref.double() - ref64).abs().max()):.3e}")
    log(f"[k1] {tag}: max|diff| {err:.3e} (limit {rtol:g} x max|ref| {scale:.3e})"
        f"{extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"K1 disagrees with its plain version: {tag}")
    return err, err / scale


def _data(n: int, seed: int, device: str):
    g = torch.Generator().manual_seed(seed)
    x = torch.sort(torch.rand(n, 1, generator=g), dim=0).values
    y = torch.sin(8.0 * x[:, 0]) + 0.1 * torch.randn(n, generator=g)
    return x.to(device), y.to(device)


def _se_kernel():
    import gaussianprocessfundamentals_tpu_torch as gpt

    kernel = gpt.SquaredExponentialKernel()
    # hyperparameters as a JAX checkpoint carries them
    gpt.params_from_numpy(kernel, {"['lengthscale']": np.float32(LENGTHSCALE)})
    return kernel


def phase_oracle() -> None:
    import gaussianprocessfundamentals_tpu_torch as gpt

    n, t = 4096, 64
    x, y = _data(n, seed=2, device="cuda")
    xt = torch.linspace(0.01, 0.99, t, device="cuda")[:, None]
    gp = gpt.GaussianProcess(_se_kernel(), noise=NOISE, device="cuda").set_data(x, y)
    post = gp.posterior(xt, method="iterative")
    gp64 = gpt.GaussianProcess(_se_kernel(), noise=NOISE, device="cuda").set_data(
        x.double(), y.double())
    ref = gp64.posterior(xt.double(), method="dense")
    torch.cuda.synchronize()
    mu_err = float((post.mean.double() - ref.mean).abs().max())
    mu_lim = 1e-3 * float(ref.mean.abs().max())
    var_err = float((post.var.double() - ref.var).abs().max())
    var_lim = 1e-3 * 1.0  # k_ss = 1 for the unscaled SE kernel
    ok = mu_err <= mu_lim and var_err <= var_lim
    log(f"[oracle] n={n} t={t}: mu max|diff| {mu_err:.3e} (limit {mu_lim:.3e}), "
        f"var max|diff| {var_err:.3e} (limit {var_lim:.1e}) vs f64 dense "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("iterative posterior disagrees with the f64 dense oracle")


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _abba_ms(kernel_fn, plain_fn, reps: int):
    """Kernel and plain times in turns: plain, kernel, kernel, plain."""
    p1 = _time_ms(plain_fn, reps)
    k1 = _time_ms(kernel_fn, reps)
    k2 = _time_ms(kernel_fn, reps)
    p2 = _time_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_main() -> dict:
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
        fused_gram_matvec,
        fused_gram_matvec_cross,
        plain_gram_matvec_cross,
    )

    x, y = _data(N_MAIN, seed=0, device="cuda")
    xt = torch.linspace(0.01, 0.99, T_MAIN, device="cuda")[:, None]
    gp = gpt.GaussianProcess(_se_kernel(), noise=NOISE, device="cuda").set_data(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_gram_matvec_cross.launches = 0
    t0 = time.perf_counter()
    post = gp.posterior(xt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_gram_matvec_cross.launches
    peak = torch.cuda.max_memory_allocated()

    stats = post.solve_stats
    truth = torch.sin(8.0 * xt[:, 0])
    rmse = float(torch.sqrt(torch.mean((post.mean - truth) ** 2)))
    finite = bool(torch.isfinite(post.mean).all() and torch.isfinite(post.var).all())
    nonneg = bool((post.var >= 0).all())
    shapes = tuple(post.mean.shape) == (T_MAIN,) and tuple(post.var.shape) == (T_MAIN,)
    log(f"[main] N={N_MAIN} t={T_MAIN} posterior(method='auto'): wall {wall:.3f} s, "
        f"CG iters {stats['iters']}, true rel resid "
        f"{[float(f'{r:.3e}') for r in stats['rel_resid']]}, "
        f"K1 launches {launches}, peak mem {peak / 1e9:.3f} GB, "
        f"mean RMSE vs sin(8x) {rmse:.5f}, var range "
        f"[{float(post.var.min()):.3e}, {float(post.var.max()):.3e}]")
    checks = {
        "K1 launched": launches > 0,
        "finite, shape": finite and shapes,
        "var >= 0": nonneg,
        "max rel CG resid < 1e-3": max(stats["rel_resid"]) < 1e-3,
        "mean RMSE < 0.01": rmse < 0.01,
        "peak memory < 4 GB": peak < 4e9,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"main path checks failed: {failed}")

    # K1 against the plain version at the main path's shapes (n = 100k)
    g = torch.Generator().manual_seed(3)
    times, worst = {}, (0.0, 0.0)
    for r in (1, 256):
        V = torch.randn(N_MAIN, r, generator=g).cuda()
        worst = _worse(worst, _check_against_plain(
            x, x, V, LENGTHSCALE, 1.0, "se", 5e-5, f64=True))
        reps = 10 if r == 1 else 3
        times[r] = _abba_ms(
            lambda: fused_gram_matvec(x, V, LENGTHSCALE, 1.0, "se"),
            lambda: plain_gram_matvec_cross(x, x, V, LENGTHSCALE, 1.0, "se"),
            reps,
        )
        bound_ms, bound_by = _bound(N_MAIN, N_MAIN, 1, r, 4 * N_MAIN * (2 + r),
                                    4 * N_MAIN * r)
        log(f"[time] K1 r={r} n={N_MAIN}: kernel {times[r][0]:.3f} ms, "
            f"plain {times[r][1]:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}) "
            f"({2 * N_MAIN * N_MAIN * r / (times[r][0] * 1e-3) / 1e12:.2f} TFLOP/s "
            f"in the kernel's product)")
    return {"launches": launches, "times": times, "worst": worst}


def _bound(n1: int, n2: int, d: int, r: int, in_bytes: int, out_bytes: int):
    """(bound_ms, bound_by) of a kernel over n1·n2 pairs with a rank-r
    product: the larger of its bytes over the memory rate and its
    operations over their peak rate (module docstring)."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = max(2.0 * n1 * n2 * (r + d) / F32_OPS_PER_S, n1 * n2 / EXP_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def _k2_check(x1, x2, U, W, ls, var, kind, rtol,
              f64=False) -> tuple[float, float]:
    """K2 against its plain version on the same inputs (the plain version
    run in float64 with ``f64``): each scalar within ``rtol`` relative.
    Returns the largest absolute and relative differences."""
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_lrvjp import (
        fused_lowrank_vjp_cross,
        plain_lowrank_vjp_cross,
    )

    got = fused_lowrank_vjp_cross(x1, x2, U, W, ls, var, kind)
    torch.cuda.synchronize()
    args = (x1, x2, U, W)
    if f64:
        args = tuple(a.double() for a in args)
    ref = plain_lowrank_vjp_cross(*args, ls, var, kind)
    torch.cuda.synchronize()
    errs = [abs(float(a) - float(b)) for a, b in zip(got, ref)]
    rels = [e / abs(float(b)) for e, b in zip(errs, ref)]
    extra = ""
    if f64:
        ref32 = plain_lowrank_vjp_cross(x1, x2, U, W, ls, var, kind)
        extra = "; plain float32 vs f64 rel err " + " ".join(
            f"{abs(float(a) - float(b)) / abs(float(b)):.2e}"
            for a, b in zip(ref32, ref))
    ok = all(bool(torch.isfinite(a)) for a in got) and max(rels) <= rtol
    tag = (f"{kind} d={x1.shape[1]} n1={x1.shape[0]} n2={x2.shape[0]} "
           f"r={U.shape[1]} cot mean {float(U.mean()):+.2f}")
    log(f"[k2] {tag}: (g_ls, g_var) {float(got[0]):.6e} {float(got[1]):.6e} "
        f"vs plain{' f64' if f64 else ''} {float(ref[0]):.6e} "
        f"{float(ref[1]):.6e}: rel err {rels[0]:.2e} {rels[1]:.2e} "
        f"(limit {rtol:g}){extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"K2 disagrees with its plain version: {tag}")
    return max(errs), max(rels)


def _cotangent(n1: int, n2: int, r: int, g, shift: float):
    """U [n1, r] and W [n2, r], standard normal plus ``shift``.

    With shift 0.5 (the JAX gate's regime) every pair's cotangent is about
    0.25·r, so the sums do not cancel, but they hardly depend on how rows
    and columns of U and W are paired. With shift 0 the cotangent has mixed
    signs and cancels heavily, as the fit's own does: a kernel that pairs a
    column of U with the wrong column of W, or misplaces a row, lands far
    from the plain version. Those checks use the plain version in float64.
    """
    return ((shift + torch.randn(n1, r, generator=g)).cuda(),
            (shift + torch.randn(n2, r, generator=g)).cuda())


def phase_k2_check() -> tuple[float, float]:
    g = torch.Generator().manual_seed(4)
    n1, n2 = 3000, 5001
    worst = (0.0, 0.0)
    for kind, d, ls, var in (("se", 1, 0.1, 1.3), ("mat32", 1, 0.2, 0.7),
                             ("mat52", 1, 0.2, 0.7), ("se", 3, 0.4, 1.3)):
        x1 = torch.rand(n1, d, generator=g).cuda()
        x2 = torch.rand(n2, d, generator=g).cuda()
        for r in (1, 17, 145, R_MAIN):
            U, W = _cotangent(n1, n2, r, g, 0.5)
            worst = _worse(worst, _k2_check(x1, x2, U, W, ls, var, kind, 1e-3))
        U, W = _cotangent(n1, n2, R_MAIN, g, 0.0)
        worst = _worse(worst, _k2_check(x1, x2, U, W, ls, var, kind,
                                        K2_RTOL_CANCEL, f64=True))
    # accumulation depth: 65,536² pairs against the float64 plain version
    n = 65_536
    x = torch.sort(torch.rand(n, 1, generator=g), dim=0).values.cuda()
    U, W = _cotangent(n, n, 17, g, 0.5)
    for kind in ("se", "mat52"):
        worst = _worse(worst, _k2_check(x, x, U, W, 0.1, 1.2, kind, 3e-3,
                                        f64=True))
    return worst


def _trend_data(n: int, seed: int):
    """The JAX package's 100k fit story data: sorted x ~ U(0, 1),
    y = 2 + 3x + sin(8x) + 0.1ε."""
    g = torch.Generator().manual_seed(seed)
    x = torch.sort(torch.rand(n, 1, generator=g), dim=0).values
    y = (2.0 + 3.0 * x[:, 0] + torch.sin(8.0 * x[:, 0])
         + 0.1 * torch.randn(n, generator=g))
    return x.cuda(), y.cuda()


def phase_fit_oracle() -> None:
    """One streamed iterative NLL + gradient against the float64 dense ones
    (the tolerances of tests/test_iterative.py: NLL rtol 0.02, ℓ gradient
    rtol 0.15)."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
        fused_gram_matvec_cross,
    )
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_lrvjp import (
        fused_lowrank_vjp_cross,
    )

    n = 4096
    x, y = _data(n, seed=5, device="cuda")
    kernel = gpt.SquaredExponentialKernel(scaled=True).set_params({
        "lengthscale": torch.tensor(LENGTHSCALE),
        "variance": torch.tensor(1.0)}).cuda()
    fused_gram_matvec_cross.launches = 0
    fused_lowrank_vjp_cross.launches = 0
    nll, g, g_noise, resid = gpt.iterative_nll_and_grad(
        kernel, x, y, NOISE, torch.Generator(device="cuda").manual_seed(0),
        num_probes=64, max_iters=100, tol=1e-4, precond_m=256,
        materialize=False)
    torch.cuda.synchronize()
    k1, k2 = fused_gram_matvec_cross.launches, fused_lowrank_vjp_cross.launches

    k64 = gpt.SquaredExponentialKernel(scaled=True).set_params({
        "lengthscale": torch.tensor(LENGTHSCALE, dtype=torch.float64),
        "variance": torch.tensor(1.0, dtype=torch.float64)}).cuda()
    x64, y64 = x.double(), y.double()
    with k64.differentiable() as p:
        ref = chol.nll(k64.gram(x64, x64), y64, NOISE, 0.0)
        g_ref = torch.autograd.grad(ref, [p["lengthscale"], p["variance"]])
    ref = ref.detach()
    nll_rel = abs(float(nll) - float(ref)) / abs(float(ref))
    ls_rel = (abs(float(g["lengthscale"]) - float(g_ref[0]))
              / abs(float(g_ref[0])))
    var_rel = abs(float(g["variance"]) - float(g_ref[1])) / abs(float(g_ref[1]))
    ok = nll_rel <= 0.02 and ls_rel <= 0.15 and k2 == 1 and k1 > 0
    log(f"[fit-oracle] n={n} streamed, 64 probes: nll {float(nll):.4f} vs f64 "
        f"dense {float(ref):.4f} (rel {nll_rel:.2e}, limit 0.02); g_ls "
        f"{float(g['lengthscale']):.4f} vs {float(g_ref[0]):.4f} (rel "
        f"{ls_rel:.2e}, limit 0.15); g_var rel {var_rel:.2e}; max rel CG "
        f"resid {float(resid.max()):.2e}; K1 launches {k1}, K2 launches {k2} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("iterative NLL + gradient disagree with the f64 "
                           "dense oracle, or K2 did not run exactly once")


def _fit_model():
    import gaussianprocessfundamentals_tpu_torch as gpt

    return gpt.GaussianProcess(gpt.SquaredExponentialKernel(scaled=True),
                               gpt.ConstantMean() + gpt.LinearMean(dim=1),
                               device="cuda")


def phase_fit() -> dict:
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
        fused_gram_matvec_cross,
    )
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_lrvjp import (
        fused_lowrank_vjp_cross,
    )

    x, y = _trend_data(N_MAIN, seed=6)
    gp = _fit_model()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_gram_matvec_cross.launches = 0
    fused_lowrank_vjp_cross.launches = 0
    t0 = time.perf_counter()
    res = gp.fit(x, y, **FIT_KWARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fused_gram_matvec_cross.launches, fused_lowrank_vjp_cross.launches
    peak = torch.cuda.max_memory_allocated()

    hist = [float(v) for v in res.history]
    frozen = res.diagnostics["frozen_frac"]
    c = float(res.mean_params["children"][0]["c"])
    slope = float(res.mean_params["children"][1]["slope"][0])
    xt = torch.linspace(0.01, 0.99, T_MAIN, device="cuda")[:, None]
    post = gp.posterior(xt)
    torch.cuda.synchronize()
    truth = 2.0 + 3.0 * xt[:, 0] + torch.sin(8.0 * xt[:, 0])
    rmse = float(torch.sqrt(torch.mean((post.mean - truth) ** 2)))
    log(f"[fit] N={N_MAIN} fit(method='auto'), {FIT_STEPS} Adam steps: wall "
        f"{wall:.3f} s, {wall / FIT_STEPS:.3f} s/step (first step included), "
        f"K1 launches {k1}, K2 launches {k2}, peak mem {peak / 1e9:.3f} GB")
    log(f"[fit] NLL history {[float(f'{v:.2f}') for v in hist]}; frozen_frac "
        f"{frozen}; noise {float(res.noise):.5f}, lengthscale "
        f"{float(res.kernel_params['lengthscale']):.5f}, variance "
        f"{float(res.kernel_params['variance']):.5f}, const {c:.4f}, slope "
        f"{slope:.4f}; posterior at {T_MAIN} points: mean RMSE vs the noise-"
        f"free function {rmse:.4f}, var range [{float(post.var.min()):.3e}, "
        f"{float(post.var.max()):.3e}]")
    checks = {
        f"K2 launches == {FIT_STEPS}": k2 == FIT_STEPS,
        "K1 launched": k1 > 0,
        "NLL history finite": all(np.isfinite(hist)),
        "last NLL below first": hist[-1] < hist[0],
        "frozen_frac == 0": frozen == 0.0,
        "peak memory < 8 GB": peak < 8e9,
        "posterior finite": bool(torch.isfinite(post.mean).all()
                                 and torch.isfinite(post.var).all()),
        "posterior var >= 0": bool((post.var >= 0).all()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"training path checks failed: {failed}")
    return {"k1": k1, "k2": k2, "x": x, "y": y}


def phase_fit_time(x) -> dict:
    """K2, then K1 at the CG width, in turns with their plain versions at
    the training path's shapes; returns K2's numbers."""
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
        fused_gram_matvec,
        plain_gram_matvec_cross,
    )
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_lrvjp import (
        fused_lowrank_vjp,
        plain_lowrank_vjp_cross,
    )

    g = torch.Generator().manual_seed(7)
    U, W = _cotangent(N_MAIN, N_MAIN, R_MAIN, g, 0.5)
    worst = _k2_check(x, x, U, W, LENGTHSCALE, 1.0, "se", 1e-3)
    U, W = _cotangent(N_MAIN, N_MAIN, R_MAIN, g, 0.0)
    worst = _worse(worst, _k2_check(x, x, U, W, LENGTHSCALE, 1.0, "se",
                                    K2_RTOL_CANCEL, f64=True))
    ms, plain_ms = _abba_ms(
        lambda: fused_lowrank_vjp(x, U, W, LENGTHSCALE, 1.0, "se"),
        lambda: plain_lowrank_vjp_cross(x, x, U, W, LENGTHSCALE, 1.0, "se"),
        3,
    )
    bound_ms, bound_by = _bound(N_MAIN, N_MAIN, 1, R_MAIN,
                                4 * 2 * N_MAIN * (1 + R_MAIN), 8)
    log(f"[time] K2 r={R_MAIN} n={N_MAIN}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}): "
        f"{100 * bound_ms / ms:.1f}% of the bound "
        f"({2 * N_MAIN * N_MAIN * R_MAIN / (ms * 1e-3) / 1e12:.2f} TFLOP/s in "
        f"the kernel's product)")
    # K1 at the fit's CG width: y and 8 probes, over all 782 x2 tiles
    V = torch.randn(N_MAIN, R_CG, generator=g).cuda()
    k1_worst = _check_against_plain(x, x, V, LENGTHSCALE, 1.0, "se", 5e-5,
                                    f64=True)
    k1_ms, k1_plain_ms = _abba_ms(
        lambda: fused_gram_matvec(x, V, LENGTHSCALE, 1.0, "se"),
        lambda: plain_gram_matvec_cross(x, x, V, LENGTHSCALE, 1.0, "se"),
        10,
    )
    k1_bound_ms, k1_bound_by = _bound(N_MAIN, N_MAIN, 1, R_CG,
                                      4 * N_MAIN * (2 + R_CG), 4 * N_MAIN * R_CG)
    log(f"[time] K1 r={R_CG} n={N_MAIN}: kernel {k1_ms:.3f} ms, plain "
        f"{k1_plain_ms:.3f} ms, bound {k1_bound_ms:.3f} ms ({k1_bound_by}): "
        f"{100 * k1_bound_ms / k1_ms:.1f}% of the bound")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "worst": worst, "k1_worst": k1_worst}


def phase_profile(x, y) -> None:
    """One fit step under torch.profiler: device time by kernel, and the
    union of the device's kernel intervals over the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the same fit again, warm: the first fit in a process pays one-time
    # set-up (library handles, lazy kernel loading)
    t0 = time.perf_counter()
    _fit_model().fit(x, y, **FIT_KWARGS)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"[profile] warm fit at N={N_MAIN}, {FIT_STEPS} steps: wall {warm:.3f} s, "
        f"{warm / FIT_STEPS:.3f} s/step")
    kw = dict(FIT_KWARGS, steps=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _fit_model().fit(x, y, **kw)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"[profile] one fit step at N={N_MAIN}: wall {wall_us / 1e3:.1f} ms, "
        f"{len(spans)} device kernels, device busy {busy / 1e3:.1f} ms "
        f"({100 * busy / wall_us:.1f}% of wall, idle "
        f"{100 * (1 - busy / wall_us):.1f}%)")
    for name, us in top:
        log(f"[profile]   {us / 1e3:9.2f} ms  {name[:100]}")


def main() -> None:
    smi = phase_device()
    phase_build()
    k1_worst = phase_kernel_check()
    phase_oracle()
    main_res = phase_main()
    k2_worst = phase_k2_check()
    phase_fit_oracle()
    fit_res = phase_fit()
    fit_time = phase_fit_time(fit_res["x"])
    phase_profile(fit_res["x"], fit_res["y"])
    k1_worst = _worse(_worse(k1_worst, main_res["worst"]), fit_time["k1_worst"])
    k2_worst = _worse(k2_worst, fit_time["worst"])
    ms, plain_ms = main_res["times"][256]
    k1_bound_ms, k1_bound_by = _bound(
        N_MAIN, N_MAIN, 1, 256, 4 * N_MAIN * (2 + 256), 4 * N_MAIN * 256)
    log(smi)
    log(json.dumps({"kernels": [{
        "name": "fused_gram_matvec_cross",
        "route": "cuda",
        "source": "gaussianprocessfundamentals_tpu_torch/csrc/gram_matvec.cu",
        "replaces": "gaussianprocessfundamentals_tpu/ops/pallas_gram.py:252",
        "launches": main_res["launches"] + fit_res["k1"],
        "launches_by_path": {"posterior": main_res["launches"],
                             "fit": fit_res["k1"]},
        "max_abs_err": k1_worst[0],
        "max_rel_err": k1_worst[1],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound_ms,
        "bound_by": k1_bound_by,
        "library_ms": None,
    }, {
        "name": "fused_lowrank_vjp_cross",
        "route": "cuda",
        "source": "gaussianprocessfundamentals_tpu_torch/csrc/lowrank_vjp.cu",
        "replaces": "gaussianprocessfundamentals_tpu/ops/pallas_gram.py:398",
        "launches": fit_res["k2"],
        "launches_by_path": {"posterior": 0, "fit": fit_res["k2"]},
        "max_abs_err": k2_worst[0],
        "max_rel_err": k2_worst[1],
        "ms": fit_time["ms"],
        "plain_ms": fit_time["plain_ms"],
        "bound_ms": fit_time["bound_ms"],
        "bound_by": fit_time["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
