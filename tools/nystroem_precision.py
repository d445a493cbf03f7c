"""How much of the Nyström posterior survives float32: the projected-process
moments computed three ways from the same float32 inputs, against
``nystroem_posterior`` in float64 at the same jitter level.

    python3 tools/nystroem_precision.py [--n 100000] [--m 2048] [--device cuda]

* float32 algebra: the JAX package's arithmetic in float32 (factor,
  triangular solves and sums all in float32; NaN where a float32
  Cholesky fails);
* the port: ``linalg.nystroem.nystroem_posterior`` (float32 Grams, the
  jitter level from the float32 K_mm, then float64 algebra);
* float64 at the configuration's jitter (1e-8): the same float64 algebra
  under another regularisation, which shows how far the jitter alone moves
  the moments.

Data: sorted x ~ U(0, 1), y = sin(6x) + 0.1ε, inducing inputs at the
rounded linspace rows of x (``fit.default_inducing``), 1,000 test points;
SE~s at three (ℓ, σ_f², σ²) points: the defaults after ~20 Adam steps
from ``fit``'s start, the noise of the data, and the start itself. Each
line prints max|Δμ| / max|μ| and max|Δvar| / max|var| against the float64
reference at the float32 level (and the float32 algebra's against the
float64 moments at jitter 1e-8), and the Nyström log likelihood by the
float32 algebra beside the float64 one.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.fit.fit import default_inducing
    from gaussianprocessfundamentals_tpu_torch.linalg import nystroem as ny
    from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import (
        add_diag,
        cholesky_or_nan,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("nystroem_precision: no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        print(f"[device] {torch.cuda.get_device_name(0)}")
    rng = np.random.default_rng(0)
    x = torch.tensor(np.sort(rng.uniform(0, 1, (args.n, 1)), 0),
                     dtype=torch.float32, device=dev)
    y = torch.sin(6 * x[:, 0]) + 0.1 * torch.tensor(
        rng.standard_normal(args.n), dtype=torch.float32, device=dev)
    z = default_inducing(x, args.m)
    xt = torch.linspace(0, 1, 1000, device=dev)[:, None]

    def kernel(ls, var, dtype):
        return gpt.SquaredExponentialKernel(scaled=True).set_params({
            "lengthscale": torch.tensor(ls, dtype=dtype),
            "variance": torch.tensor(var, dtype=dtype)}).to(dev)

    def float32_algebra(k, noise):
        K_mm = k.gram(z, z)
        L_mm = cholesky_or_nan(add_diag(K_mm, ny.nystroem_jitter(K_mm, 1e-8)))
        A = torch.linalg.solve_triangular(L_mm.mT, k.gram(x, z), upper=True,
                                          left=False)
        L_core = cholesky_or_nan(add_diag(A.T @ A, noise))
        B = torch.linalg.solve_triangular(L_mm.mT, k.gram(xt, z),
                                          upper=True, left=False)
        w = torch.cholesky_solve((A.T @ y)[:, None], L_core)[:, 0]
        C = torch.linalg.solve_triangular(L_core, B.T, upper=False)
        var = k.diag(xt) - (B * B).sum(-1) + noise * (C * C).sum(0)
        # the log likelihood the fit would minimise, by the same factors
        alpha = (y - A @ w) / noise
        logdet = ((x.shape[0] - z.shape[0]) * np.log(noise)
                  + 2.0 * torch.log(torch.diagonal(L_core)).sum())
        ll = -0.5 * (y * alpha).sum() - 0.5 * logdet
        return (B @ w, torch.clamp_min(var, 0.0)), float(ll)

    def rel(got, ref):
        return tuple(float((g.double() - r).abs().max() / r.abs().max())
                     for g, r in zip(got, ref))

    for ls, var, noise in ((0.15, 0.25, 2.7e-4), (0.2, 1.0, 1e-2),
                           (0.1, 0.1, 1e-4)):
        k32, k64 = kernel(ls, var, torch.float32), kernel(ls, var, torch.float64)
        with torch.no_grad():
            jit = float(ny.nystroem_jitter(k32.gram(z, z), 1e-8))
            f32, ll32 = float32_algebra(k32, noise)
        port = ny.nystroem_posterior(k32, x, y, z, xt, noise, 1e-8)
        args64 = (k64, x.double(), y.double(), z.double(), xt.double(), noise)
        ref = ny.nystroem_posterior(*args64, jit)
        cfg = ny.nystroem_posterior(*args64, 1e-8)
        ll64 = float(ny.nystroem_mll(k64, *args64[1:4], noise, jit)
                     + 0.5 * args.n * 1.8378770664093453)
        print(f"[nystroem-precision] n={args.n} m={args.m} l={ls} var={var} "
              f"noise={noise} jitter level {jit:.3e}, max|var| "
              f"{float(ref[1].max()):.3e}; vs float64 at that level, "
              "(mu, var) of max: float32 algebra "
              f"{rel(f32, ref)}; the port {rel(port, ref)}; float64 at "
              f"jitter 1e-8 {rel(cfg, ref)}; float32 algebra against that "
              f"{rel(f32, cfg)}; log likelihood (without "
              f"-n/2 log 2pi) by the float32 algebra {ll32:.6g}, float64 "
              f"{ll64:.6g}", flush=True)


if __name__ == "__main__":
    main()
