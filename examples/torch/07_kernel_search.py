"""Greedy compositional kernel search through the PyTorch port, on the
Mauna Loa CO₂ record: find the kernel's structure, not only its
hyperparameters.

    python examples/torch/07_kernel_search.py [--max-depth 2]
        [--steps 150] [--device cuda]

The counterpart of ``examples/07_kernel_search.py``:
``greedy_kernel_search`` over the base kernels SE, PER, LIN and
Matérn-5/2 on ``data/d2_mauna_loa.csv`` (``load_named``, float64), two
expansion rounds, 150 Adam steps a candidate, seed 0; then the best
structure and its BIC.
"""
import argparse

import torch

import gaussianprocessfundamentals_tpu_torch as gpt


def main(max_depth=2, steps=150, device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    di = gpt.load_named("mauna_loa", device=dev)
    res = gpt.greedy_kernel_search(
        di.x_train, di.y_train, max_depth=max_depth, seed=0, verbose=True,
        fit_kwargs={"steps": steps},
    )
    print(f"\nbest structure: {res.kernel}")
    print(f"BIC: {res.score:.1f}  ({len(res.history)} candidates evaluated)")
    return {"best": str(res.kernel), "bic": res.score,
            "candidates": len(res.history), "history": res.history}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-depth", type=int, default=2)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(max_depth=args.max_depth, steps=args.steps, device=args.device)
