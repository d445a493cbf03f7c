"""BASELINE config 2 through the PyTorch port: the composite kernel
grammar on the Mauna Loa CO₂ record.

    python examples/torch/02_mauna_loa_composite.py [--steps 400]
        [--device cuda]

The counterpart of ``examples/02_mauna_loa_composite.py``: SE·PER
(seasonal) + SE (trend) + LIN (drift) + WN on ``data/d2_mauna_loa.csv``
through ``load_named`` (x and y min-max scaled, a seeded 80/20 split, in
float64, the loader's dtype), fitted by Adam for 400 steps with the noise
optimised, then the test MSE of the posterior mean.
"""
import argparse
import time

import torch

import gaussianprocessfundamentals_tpu_torch as gpt


def main(steps=400, device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    di = gpt.load_named("mauna_loa", device=dev)
    kernel = (
        gpt.SquaredExponentialKernel(scaled=True) * gpt.PeriodicKernel()
        + gpt.SquaredExponentialKernel(scaled=True)
        + gpt.LinearKernel()
        + gpt.WhiteNoiseKernel(scaled=True)
    )
    gp = gpt.GaussianProcess(kernel, device=dev)
    t0 = time.perf_counter()
    res = gp.fit(di.x_train, di.y_train, method="adam", steps=steps,
                 optimize_noise=True)
    dt = time.perf_counter() - t0
    print(f"fit in {dt:.2f}s: nll {res.nll_pre:.1f} -> {res.nll_post:.1f}")
    mu, _, _ = gp.predict(di.x_test)
    mse = float(torch.mean((mu - di.y_test) ** 2))
    print(f"kernel: {gp.kernel}")
    print(f"test MSE (normalized y): {mse:.6f}")
    return {"fit_s": dt, "nll_pre": float(res.nll_pre),
            "nll_post": float(res.nll_post), "test_mse": mse}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(steps=args.steps, device=args.device)
