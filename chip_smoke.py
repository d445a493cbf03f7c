"""Drive the PyTorch port's serving path once on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions and the TF32 flags (both off: full-float32 matmuls);
2. build: compile the Gram·V kernel (csrc/gram_matvec.cu, sm_90a) from the
   checkout;
3. kernel check: the kernel against its plain PyTorch version on the card
   at ragged shapes, for SE, Matérn-3/2 and Matérn-5/2 at d = 1 and SE at
   d = 3;
   Phase 5 repeats the check at the main path's shapes (n = 100k,
   r = 1 and 256);
4. small-n oracle: the iterative posterior (through the kernel) against a
   float64 dense Cholesky posterior, n = 4096, 64 test points;
5. main path: ``GaussianProcess(...).posterior`` at N = 100,000 training
   points and 1,000 test points through ``method="auto"`` (the matrix-free
   chunked mBCG route), with the kernel's launch count, CG residuals,
   accuracy against the noise-free function, peak device memory, and the
   kernel's time against the plain version's at the main path's shapes.

The second-to-last line is a JSON object describing the kernel; the last
is ``{"ok": true, "device": {...}}``. Without a CUDA device it fails.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

N_MAIN = 100_000
T_MAIN = 1_000
NOISE = 1e-2
LENGTHSCALE = 0.1


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


def phase_build() -> float:
    from gaussianprocessfundamentals_tpu_torch.ops import cuda_build, cuda_gram

    t0 = time.perf_counter()
    cuda_gram._lib()
    dt = time.perf_counter() - t0
    log(f"[build] gram_matvec.cu -> {cuda_build.library_path('gram_matvec.cu').name} "
        f"in {dt:.2f} s")
    return dt


def phase_kernel_check() -> float:
    """K1 against its plain version on the card; returns the largest
    absolute difference over every case."""
    g = torch.Generator().manual_seed(1)
    n1, n2 = 3000, 5001
    worst_abs = 0.0
    cases = [("se", 1, 0.1, 1.3, 5e-5), ("mat32", 1, 0.2, 0.7, 5e-5),
             ("mat52", 1, 0.2, 0.7, 5e-5), ("se", 3, 0.4, 1.3, 5e-4)]
    for kind, d, ls, var, rtol in cases:
        x1 = torch.rand(n1, d, generator=g).cuda()
        x2 = torch.rand(n2, d, generator=g).cuda()
        for r in (1, 9, 64, 257):
            V = torch.randn(n2, r, generator=g).cuda()
            err = _check_against_plain(x1, x2, V, ls, var, kind, rtol)
            worst_abs = max(worst_abs, err)
    return worst_abs


def _check_against_plain(x1, x2, V, ls, var, kind, rtol, f64=False) -> float:
    """K1 against its plain version on the same inputs: max|diff| must be
    within ``rtol`` of max|ref| (the JAX package's on-chip gates: 5e-5 at
    d = 1, 5e-4 at SE d = 3). With ``f64``, also print both versions'
    distance from the plain version run in float64."""
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
    return err


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
    times, worst_abs = {}, 0.0
    for r in (1, 256):
        V = torch.randn(N_MAIN, r, generator=g).cuda()
        worst_abs = max(worst_abs, _check_against_plain(
            x, x, V, LENGTHSCALE, 1.0, "se", 5e-5, f64=True))
        reps = 10 if r == 1 else 3
        times[r] = _abba_ms(
            lambda: fused_gram_matvec(x, V, LENGTHSCALE, 1.0, "se"),
            lambda: plain_gram_matvec_cross(x, x, V, LENGTHSCALE, 1.0, "se"),
            reps,
        )
        log(f"[time] K1 r={r} n={N_MAIN}: kernel {times[r][0]:.3f} ms, "
            f"plain {times[r][1]:.3f} ms "
            f"({2 * N_MAIN * N_MAIN * r / (times[r][0] * 1e-3) / 1e12:.2f} TFLOP/s "
            f"in the kernel's product)")
    return {"launches": launches, "times": times, "max_abs_err": worst_abs}


def main() -> None:
    smi = phase_device()
    phase_build()
    worst = phase_kernel_check()
    phase_oracle()
    main_res = phase_main()
    ms, plain_ms = main_res["times"][256]
    log(json.dumps({"kernels": [{
        "name": "fused_gram_matvec_cross",
        "route": "cuda",
        "source": "gaussianprocessfundamentals_tpu_torch/csrc/gram_matvec.cu",
        "replaces": "gaussianprocessfundamentals_tpu/ops/pallas_gram.py:252",
        "launches": main_res["launches"],
        "max_abs_err": max(worst, main_res["max_abs_err"]),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
