"""BASELINE config 1 through the PyTorch port: an exact GP, SE kernel, on
1-D synthetic data, N = 1,000.

    python examples/torch/01_exact_gp.py [--n 1000] [--plot out.svg]
        [--device cuda]

The counterpart of ``examples/01_exact_gp.py``: the same data
(``synth_se``, ℓ 0.2, noise sd 0.1, seed 0), the dense Cholesky NLL fitted
by L-BFGS with the noise optimised, then the posterior at 200 points on
[0, 1]; ``--plot`` draws it with its ±2σ band through the port's
``viz.plots.plot_posterior``. The data take torch's default dtype
(``default_dtype()``, float32 unless the caller sets another), as the JAX
script's take JAX's (float32 without x64).
"""
import argparse
import time

import torch

import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu_torch.config import default_dtype


def main(n=1000, plot=None, device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    x, y = gpt.synth_se(n=n, lengthscale=0.2, noise_sd=0.1, seed=0)
    x = torch.tensor(x, dtype=default_dtype(), device=dev)
    y = torch.tensor(y, dtype=default_dtype(), device=dev)

    gp = gpt.GaussianProcess(gpt.SquaredExponentialKernel(scaled=True),
                             device=dev)
    t0 = time.perf_counter()
    res = gp.fit(x, y, method="lbfgs", optimize_noise=True)
    dt = time.perf_counter() - t0
    out = {"fit_s": dt, "nll_pre": float(res.nll_pre),
           "nll_post": float(res.nll_post),
           "lengthscale": float(res.kernel_params["lengthscale"]),
           "variance": float(res.kernel_params["variance"]),
           "noise": float(res.noise)}
    print(f"fit in {dt:.2f}s: nll {out['nll_pre']:.1f} -> "
          f"{out['nll_post']:.1f}")
    print(f"lengthscale={out['lengthscale']:.4f} "
          f"variance={out['variance']:.4f} noise={out['noise']:.5f}")

    xs = torch.linspace(0, 1, 200, dtype=x.dtype, device=dev)[:, None]
    post = gp.posterior(xs)
    out.update(mean_min=float(post.mean.min()),
               mean_max=float(post.mean.max()),
               mean_sd=float(post.sd.mean()))
    print(f"posterior: mean range [{out['mean_min']:.2f}, "
          f"{out['mean_max']:.2f}], mean sd {out['mean_sd']:.3f}")
    if plot:
        gpt.plot_posterior(xs, post.mean, post.sd, x_train=x, y_train=y,
                           path=plot)
        print("plot:", plot)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--plot", default=None, help="path for an SVG plot")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(n=args.n, plot=args.plot, device=args.device)
