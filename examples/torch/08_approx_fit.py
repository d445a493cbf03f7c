"""Fitting an approximation objective through the PyTorch port: Nyström
with trainable inducing inputs, then a fit with the hyperparameter bounds
enforced.

    python examples/torch/08_approx_fit.py [--n 20000] [--m 128]
        [--device cuda]

The counterpart of ``examples/08_approx_fit.py``: ``synth_se`` data (ℓ
0.2, noise sd 0.1, seed 0, in torch's default dtype, as the JAX script's
take JAX's); ``fit(approximation="nystroem", n_inducing=128,
optimize_inducing=True)``, 300 Adam steps with the inducing locations in
the optimised parameters; the facade's O(nm²) projected-process posterior
at 200 points; then the exact L-BFGS fit of an unscaled SE on the first
2,000 rows with each step projected into ``kernel.bounds``.
"""
import argparse
import time

import numpy as np
import torch

import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu_torch.config import default_dtype


def main(n=20_000, m=128, steps=300, device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    x, y = gpt.synth_se(n=n, lengthscale=0.2, noise_sd=0.1, seed=0)
    x = torch.tensor(x, dtype=default_dtype(), device=dev)
    y = torch.tensor(y, dtype=default_dtype(), device=dev)

    gp = gpt.GaussianProcess(gpt.SquaredExponentialKernel(scaled=True),
                             device=dev)
    t0 = time.perf_counter()
    res = gp.fit(
        x, y, method="adam", steps=steps, optimize_noise=True,
        approximation="nystroem", n_inducing=m, optimize_inducing=True,
    )
    dt = time.perf_counter() - t0
    out = {"fit_s": dt, "nll_pre": float(res.nll_pre),
           "nll_post": float(res.nll_post),
           "inducing_std": float(torch.std(res.inducing, correction=0))}
    print(f"nystroem m={m} fit in {dt:.2f}s: "
          f"nll {out['nll_pre']:.1f} -> {out['nll_post']:.1f}")
    print(f"inducing moved by {out['inducing_std']:.3f} (std)")

    # the posterior goes through the O(nm²) projected-process predictive
    xs = torch.linspace(0, 1, 200, dtype=x.dtype, device=dev)[:, None]
    post = gp.posterior(xs)
    out.update(mean_min=float(post.mean.min()),
               mean_max=float(post.mean.max()),
               sd_nonnegative=bool((post.sd >= 0).all()))
    print(f"posterior mean range [{out['mean_min']:.2f}, "
          f"{out['mean_max']:.2f}], sd>=0: {out['sd_nonnegative']}")

    # the exact fit on a subset with the bounds enforced at every step
    sub = slice(0, min(n, 2000))
    resb = gpt.fit(
        gpt.SquaredExponentialKernel().to(dev), x[sub], y[sub],
        method="lbfgs", optimize_noise=True, enforce_bounds=True,
    )
    xsub = x[sub].cpu().numpy()
    xr = np.stack([xsub.min(0), xsub.max(0)], -1)
    lo, hi = gpt.SquaredExponentialKernel().bounds(xr, xsub.shape[0])
    out.update(bounded_lengthscale=float(resb.kernel_params["lengthscale"]),
               lengthscale_lo=float(lo["lengthscale"]),
               lengthscale_hi=float(hi["lengthscale"]))
    print(f"bounded fit: lengthscale {out['bounded_lengthscale']:.4f} in "
          f"[{out['lengthscale_lo']:.4f}, {out['lengthscale_hi']:.4f}]")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(n=args.n, m=args.m, device=args.device)
