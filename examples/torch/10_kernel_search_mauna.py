"""Kernel search at scale on the Mauna Loa CO₂ record through the PyTorch
port, end to end.

    python examples/torch/10_kernel_search_mauna.py [--max-depth 2]
        [--restarts 2] [--steps 150] [--device cuda]

The counterpart of ``examples/10_kernel_search_mauna.py``: the greedy
BIC-guided structure search (``greedy_kernel_search``) over the base
kernels SE, PER, LIN and Matérn-5/2 with 2 random restarts a candidate
(one after another) and 150 Adam steps each, on ``data/d2_mauna_loa.csv``
(``load_named``, float64); then the found structure's posterior mean on
the held-out rows (test MSE), the BIC trace, and one JSON line.
"""
import argparse
import json
import time

import torch

import gaussianprocessfundamentals_tpu_torch as gpt


def main(max_depth=2, restarts=2, steps=150, device="cuda"):
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    di = gpt.load_named("mauna_loa", device=dev)
    n = di.n_train
    print(f"Mauna Loa: n_train={n} (real-series reconstruction, "
          "data/make_mauna_loa.py)")
    t0 = time.perf_counter()
    res = gpt.greedy_kernel_search(
        di.x_train, di.y_train, max_depth=max_depth, seed=0, verbose=True,
        fit_kwargs={"steps": steps, "restarts": restarts,
                    "optimize_noise": True},
    )
    wall = time.perf_counter() - t0
    print(f"\nbest structure: {res.kernel}")
    print(f"BIC: {res.score:.1f}  ({len(res.history)} candidates, "
          f"{wall:.1f}s)")
    # held-out quality of the found structure (its hyperparameters are
    # installed in res.kernel)
    gp = gpt.GaussianProcess(res.kernel, noise=res.noise, device=dev)
    gp.set_data(di.x_train, di.y_train)
    mu, _, _ = gp.predict(di.x_test)
    mse = float(torch.mean((mu - di.y_test) ** 2))
    print(f"test MSE (normalized y): {mse:.6f}")
    out = {"config": "kernel_search_mauna", "n": int(n),
           "candidates": len(res.history), "best": str(res.kernel),
           "bic": float(res.score), "test_mse": mse, "wall_s": wall,
           "restarts": restarts, "data": "real (reconstruction)"}
    print(json.dumps(dict(out, bic=round(out["bic"], 1),
                          test_mse=round(mse, 6), wall_s=round(wall, 1))))
    return dict(out, history=res.history)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-depth", type=int, default=2)
    ap.add_argument("--restarts", type=int, default=2)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(max_depth=args.max_depth, restarts=args.restarts, steps=args.steps,
         device=args.device)
