"""Large-n exact GP through the PyTorch port: automatic routing, then the
mesh-sharded streaming iterative fit, one process per rank.

    python examples/torch/09_streaming_multichip.py --nproc 2 --device cpu
    python examples/torch/09_streaming_multichip.py --nproc 2 --device cuda
    torchrun --standalone --nproc-per-node 4 \\
        examples/torch/09_streaming_multichip.py --device cuda --backend nccl

The counterpart of ``examples/09_streaming_multichip.py``:

1. ``fit(method="auto")``: dense L-BFGS below 8k rows, Adam over the
   factorisation-free mBCG + SLQ objective from there on (rank 0 alone:
   it is a single-process call);
2. ``fit_iterative(mesh=…)``: each rank contracts its K(x_rows, x) panel
   against the replicated right-hand side through the Gram·V kernel (no
   resident K panels; per-rank memory O(n·(d + r))), the panels
   all-gathered, the gradient scalars all-reduced.
"""
import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

import gaussianprocessfundamentals_tpu_torch as gpt


def run(args) -> None:
    """Every rank's part; rank 0 prints."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if args.device == "cuda" else torch.device("cpu"))
    rank0 = dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    rng = np.random.default_rng(0)
    n = args.n
    xn = np.sort(rng.uniform(0, 1, (n, 1)), 0)
    yn = np.sin(8 * xn[:, 0]) + 0.1 * rng.standard_normal(n)
    x = torch.tensor(xn, dtype=torch.float32, device=dev)
    y = torch.tensor(yn, dtype=torch.float32, device=dev)

    if rank0:  # 1. automatic routing, the one-call API
        t0 = time.perf_counter()
        res = gpt.fit(gpt.SquaredExponentialKernel(scaled=True).to(dev), x, y,
                      generator=torch.Generator(device=dev).manual_seed(0),
                      method="auto", optimize_noise=True, noise=1e-2,
                      steps=args.steps)
        route = "iterative" if res.diagnostics else "dense-lbfgs"
        say(f"fit(auto): n={n} {time.perf_counter() - t0:.1f}s "
            f"nll {res.nll_pre:.1f} -> {res.nll_post:.1f} "
            f"noise={float(res.noise):.4f} route={route}")

    # 2. the mesh-sharded streaming fit across all ranks
    mesh = gpt.single_axis_mesh("tp")
    say(f"mesh: {mesh.shape}, {dist.get_backend()} on {args.device}")
    t0 = time.perf_counter()
    kp, noise, hist, diag = gpt.fit_iterative(
        gpt.SquaredExponentialKernel().to(dev), x, y,
        torch.Generator(device=dev).manual_seed(1), steps=args.steps, lr=0.08,
        num_probes=4, max_iters=50, precond_m=min(128, n // 4), mesh=mesh,
        mesh_axis="tp", resid_guard=0.5, return_diagnostics=True)
    say(f"fit_iterative(mesh): {time.perf_counter() - t0:.1f}s "
        f"nll {float(hist[0]):.1f} -> {float(hist[-1]):.1f} "
        f"ls={float(kp['lengthscale']):.4f} noise={float(noise):.4f} "
        f"frozen_frac={diag['frozen_frac']:.2f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--nproc", type=int, default=2,
                    help="ranks to spawn (ignored under torchrun)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)
    if "RANK" in os.environ:  # started by torchrun
        gpt.init_multihost(args.backend, args.device)
        run(args)
        dist.destroy_process_group()
    else:
        gpt.launch(run, args.nproc, (args,), backend=args.backend,
                   device=args.device, threads=1 if args.device == "cpu"
                   else 0)


if __name__ == "__main__":
    main()
