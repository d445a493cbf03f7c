"""How often BASELINE config 4's SVGP fit (chip_smoke.py phase 28: SE~s,
N = 100,000, m = 512, batch 4,096, lr 1e-2, 3,000 Adam steps, float32)
ends in a transient, over generator seeds, on one GPU.

    python3 tools/svgp_transients.py

Inducing inputs that Adam moves across each other (steps of ~lr = 0.01
against ℓ ≈ 0.05) leave the whitened basis steep for a few steps, and the
−ELBO jumps by up to ~1.7e5 before Adam recovers; the JAX package's
``fit_svgp`` shows the same (ROADMAP.md §3 item 4). For each seed of the
fit's generator, on example 04's data and on the torch-drawn data of the
phase's first draft (``torch.rand`` / ``torch.randn``, seed 0), prints the
transient steps after step 1,000 (``chip_smoke.svgp_transient_steps``),
the last step's −ELBO and the prediction MSE on the first 20,000 rows at
the fit's final parameters. Without a GPU it fails.
"""
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent


def _torch_data(n: int):
    g = torch.Generator().manual_seed(0)
    x = torch.rand(n, 1, generator=g)
    y = (torch.sin(12.0 * x[:, 0]) + 0.5 * torch.sin(31.0 * x[:, 0])
         + 0.1 * torch.randn(n, generator=g))
    return x.cuda(), y.cuda()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("svgp_transients: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import gaussianprocessfundamentals_tpu_torch as gpt

    cs.phase_device()
    runs = [("example 04", cs.svgp_data(cs.N_SVGP), seed) for seed in range(4)]
    runs.append(("torch draft", _torch_data(cs.N_SVGP), 0))
    for label, (x, y), seed in runs:
        kernel = gpt.SquaredExponentialKernel(scaled=True).cuda()
        t0 = time.perf_counter()
        params, hist = gpt.fit_svgp(
            kernel, x, y, m=cs.M_SVGP,
            generator=torch.Generator(device="cuda").manual_seed(seed),
            batch_size=cs.B_SVGP, steps=cs.SVGP_STEPS, lr=1e-2)
        h = hist.cpu().numpy()
        mu, _ = gpt.svgp_predict(kernel, params, x[:cs.SVGP_MSE_ROWS])
        mse = float(torch.mean((mu - y[:cs.SVGP_MSE_ROWS]) ** 2))
        print(f"[svgp-transients] {label} data, generator seed {seed}: "
              f"{time.perf_counter() - t0:.1f} s; transient steps after "
              f"step 1000 {cs.svgp_transient_steps(h)}; -ELBO median after "
              f"step 1000 {np.median(h[1000:]):.1f}, last {h[-1]:.1f}; MSE on "
              f"the first {cs.SVGP_MSE_ROWS} rows {mse:.5f}", flush=True)


if __name__ == "__main__":
    main()
