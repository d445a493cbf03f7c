"""Pathwise (Matheron) posterior sampling through the PyTorch port, with
random Fourier features.

    python examples/torch/06_pathwise_sampling.py [--n 2000] [--t 1000]
        [--samples 64] [--device cuda]

The counterpart of ``examples/06_pathwise_sampling.py``: ``synth_se``
data (ℓ 0.2, noise sd 0.1, seed 0, in torch's default dtype, as the JAX
script's take JAX's), Matérn-5/2~s at ℓ 0.2 and variance 1, noise 0.01,
64 posterior paths at 1,000 test points from 2,048 features and one
batched CG solve (300 iterations) for all paths: O(D·t) a path instead
of a t×t Cholesky.
"""
import argparse
import time

import torch

import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu_torch.config import default_dtype


def main(n=2000, t=1000, num_samples=64, device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    x, y = gpt.synth_se(n=n, lengthscale=0.2, noise_sd=0.1, seed=0)
    x = torch.tensor(x, dtype=default_dtype(), device=dev)
    y = torch.tensor(y, dtype=default_dtype(), device=dev)
    xs = torch.linspace(0, 1, t, dtype=x.dtype, device=dev)[:, None]
    k = gpt.Matern52Kernel(scaled=True).set_params({
        "lengthscale": torch.tensor(0.2), "variance": torch.tensor(1.0),
    }).to(dev, x.dtype)

    t0 = time.perf_counter()
    s = gpt.pathwise_posterior_samples(
        k, x, y, xs, 0.01, torch.Generator(device=dev).manual_seed(0),
        num_samples=num_samples, num_features=2048, max_iters=300,
    )
    at = s[:, t // 2].cpu()  # waits for the device
    dt = time.perf_counter() - t0
    out = {"wall_s": dt, "point_evals_per_s": num_samples * t / dt,
           "mean_at_half": float(at.mean()),
           "sd_at_half": float(at.std(correction=0))}
    print(f"{num_samples} posterior paths at {t} test points in {dt:.2f}s "
          f"({out['point_evals_per_s']:.0f} point-evals/s)")
    print(f"sample mean/sd at x*=0.5: {out['mean_at_half']:.3f} ± "
          f"{out['sd_at_half']:.3f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--t", type=int, default=1000)
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(n=args.n, t=args.t, num_samples=args.samples, device=args.device)
