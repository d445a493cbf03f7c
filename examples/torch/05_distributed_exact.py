"""BASELINE config 5 through the PyTorch port: the exact GP by the
block-cyclic distributed Cholesky over the ranks of a mesh, one process
per rank.

    # P ranks spawned here (gloo on the CPU, or P gloo ranks on one GPU)
    python examples/torch/05_distributed_exact.py --nproc 2 --device cpu
    python examples/torch/05_distributed_exact.py --nproc 2 --device cuda
    # one rank per GPU over NCCL, on one host or several
    torchrun --standalone --nproc-per-node 4 \\
        examples/torch/05_distributed_exact.py --device cuda --backend nccl

The counterpart of ``examples/05_distributed_exact.py``: the same data
(``synth_se``, SE ℓ 0.2, σ² 0.01), the distributed NLL timed twice, the
exact posterior at 64 points, then ``fit_distributed`` (8 probes). Each
rank builds only its cyclic block-rows of K (through the dense Gram
kernel on a card); nothing holds the whole K.
"""
import argparse
import os
import time

import torch
import torch.distributed as dist

import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu_torch.parallel.block_cholesky import (
    cyclic_gram,
)


def run(args) -> None:
    """Every rank's part; rank 0 prints."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if args.device == "cuda" else torch.device("cpu"))
    mesh = gpt.single_axis_mesh("tp")
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say(f"{dist.get_world_size()} rank(s), {dist.get_backend()} on "
        f"{args.device}")
    x, y = gpt.synth_se(n=args.n, lengthscale=0.2, noise_sd=0.1, seed=0)
    x = torch.tensor(x, dtype=torch.float32, device=dev)
    y = torch.tensor(y, dtype=torch.float32, device=dev)
    k = gpt.SquaredExponentialKernel().to(dev)
    k.set_params({"lengthscale": torch.tensor(0.2, device=dev)})

    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        with torch.no_grad():
            nll = float(gpt.distributed_nll(
                cyclic_gram(k, x, args.block, mesh), y, 0.01, 1e-6, mesh,
                block=args.block))
        times.append(time.perf_counter() - t0)
    say(f"distributed NLL n={args.n} (block={args.block}): {nll:.1f}; "
        f"first {times[0]:.2f} s, second {times[1] * 1e3:.0f} ms")

    xs = torch.linspace(0.05, 0.95, 64, device=dev)[:, None]
    t0 = time.perf_counter()
    mu, var = gpt.distributed_posterior(k, x, y, xs, 0.01, 1e-6, mesh,
                                        block=args.block)
    say(f"distributed exact posterior (64 test pts): "
        f"{time.perf_counter() - t0:.2f} s; sd range "
        f"[{float(var.sqrt().min()):.3f}, {float(var.sqrt().max()):.3f}]")

    gen = torch.Generator(device=dev).manual_seed(0)
    kp, noise, hist = gpt.fit_distributed(
        k, x, y, mesh, gen, block=args.block, steps=args.fit_steps, probes=8,
        lr=0.1)
    say(f"distributed fit: nll {float(hist[0]):.1f} -> {float(hist[-1]):.1f}, "
        f"lengthscale {float(kp['lengthscale']):.3f}, noise "
        f"{float(noise):.4f}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--fit-steps", type=int, default=30)
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
