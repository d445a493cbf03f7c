"""BASELINE config 4 through the PyTorch port: a sparse variational GP
(inducing points, minibatch ELBO) at N = 100,000. O(bm² + m³) a step: N
never enters a Cholesky.

    python examples/torch/04_svgp_large.py [--n 100000 --m 512
        --steps 3000 --batch 4096] [--device cuda]

The counterpart of ``examples/04_svgp_large.py``: the same data (numpy's
``default_rng(0)``: x ~ U(0, 1), y = sin(12x) + 0.5·sin(31x) + 0.1ε, in
float32), ``fit_svgp`` of SE~s with Adam at lr 1e-2, then ``svgp_predict``
at the first 20,000 training inputs and their MSE.
"""
import argparse
import time

import numpy as np
import torch

import gaussianprocessfundamentals_tpu_torch as gpt


def main(n=100_000, m=512, steps=3000, batch=4096, device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (n, 1))
    f = np.sin(12 * x[:, 0]) + 0.5 * np.sin(31 * x[:, 0])
    y = f + 0.1 * rng.standard_normal(n)
    x = torch.tensor(x, dtype=torch.float32, device=dev)
    y = torch.tensor(y, dtype=torch.float32, device=dev)

    t0 = time.perf_counter()
    params, hist = gpt.fit_svgp(
        gpt.SquaredExponentialKernel(scaled=True).to(dev), x, y, m=m,
        steps=steps, batch_size=batch,
        generator=torch.Generator(device=dev).manual_seed(0), lr=1e-2)
    h = hist.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"SVGP fit N={n} m={m}: {steps} steps in {dt:.1f}s "
          f"({steps / dt:.0f} steps/s)")
    print(f"-ELBO: {float(h[0]):.0f} -> {float(h[-1]):.0f}")

    rows = min(n, 20_000)
    fm, _ = gpt.svgp_predict(
        gpt.SquaredExponentialKernel(scaled=True).to(dev), params, x[:rows])
    mse = float(torch.mean((fm - y[:rows]) ** 2))
    print(f"pred MSE on {rows // 1000}k train points: {mse:.4f} "
          f"(noise floor 0.01)")
    return {"fit_s": dt, "steps_per_s": steps / dt, "elbo_first": float(h[0]),
            "elbo_last": float(h[-1]), "pred_mse": mse}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(n=args.n, m=args.m, steps=args.steps, batch=args.batch,
         device=args.device)
