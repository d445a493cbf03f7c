"""BASELINE config 3 through the PyTorch port: NUTS over the hyperparameters
of a Matérn-5/2 GP, the chains on a batch axis of one GPU.

    python examples/torch/03_nuts_matern.py [--n 400] [--chains 8]
        [--device cuda]

The counterpart of ``examples/03_nuts_matern.py``: the same data
(``synth_se``), the N(0, 3²) prior on the unconstrained hyperparameters,
chains from random points inside the bounds, 300 warmup transitions and
300 draws at max_depth 7; then the lengthscale's split-R̂ and ESS and the
noise variance against its truth (0.01). The log posterior of all chains
is one batched Cholesky (``make_stacked_nll``), in float64.
"""
import argparse
import time

import torch

import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu_torch.fit.fit import init_uparams
from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    ravel_tree,
    tree_leaves,
)


def main(n=400, chains=8, num_samples=300, num_warmup=300, device="cuda"):
    x, y = gpt.synth_se(n=n, lengthscale=0.2, noise_sd=0.1, seed=0)
    x = torch.tensor(x, dtype=torch.float64, device=device)
    y = torch.tensor(y, dtype=torch.float64, device=device)
    kern = gpt.Matern52Kernel(scaled=True).to(device)
    nll = gpt.make_stacked_nll(kern, gpt.ZeroMean(), x, y,
                               optimize_noise=True)

    def logprob(u):  # [chains]: the NLL and the N(0, 3²) prior on u
        return -nll(u) - 0.5 * sum(
            (l ** 2).reshape(chains, -1).sum(-1) for l in tree_leaves(u)) / 9.0

    starts = [init_uparams(kern, gpt.ZeroMean(), [[0.0, 1.0]], n,
                           generator=torch.Generator().manual_seed(i),
                           dtype=torch.float64, optimize_noise=True,
                           device=device)
              for i in range(chains)]
    _, unravel = ravel_tree(starts[0])
    q0s = unravel(torch.stack([ravel_tree(u)[0] for u in starts]))

    gen = torch.Generator(device=device).manual_seed(7)
    t0 = time.perf_counter()
    res = gpt.nuts_chains(logprob, q0s, gen, num_samples=num_samples,
                          num_warmup=num_warmup, max_depth=7)
    res.log_probs.cpu()  # wait for the device
    dt = time.perf_counter() - t0
    print(f"{chains} chains x {num_samples} draws in {dt:.1f}s "
          f"({chains * num_samples / dt:.1f} samples/s, warmup included)")
    ls = torch.exp(res.samples["kernel"]["lengthscale"]).cpu()
    noise = torch.exp(res.samples["log_noise"]).cpu()
    print(f"accept={float(res.accept_stat.mean()):.2f} "
          f"divergences={int(res.diverging.sum())} "
          f"mean leapfrogs/draw={float(res.num_steps.mean()):.1f}")
    print(f"lengthscale: {float(ls.mean()):.3f} ± {float(ls.std()):.3f} "
          f"(truth 0.2), "
          f"rhat={float(gpt.potential_scale_reduction(torch.log(ls))):.3f}")
    print(f"noise var: {float(noise.mean()):.4f} ± {float(noise.std()):.4f} "
          f"(truth 0.01)")
    print(f"ESS(log ls): "
          f"{float(gpt.effective_sample_size(torch.log(ls))):.0f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(n=args.n, chains=args.chains, device=args.device)
