"""The Mauna Loa composite fit of chip_smoke.py (phase 14: N = 100,000,
10 Adam steps, the 100k story's knobs) over several probe seeds, on one
GPU: per seed the share of steps the residual guard skipped and the NLL
history.

    python3 tools/composite_fit_seeds.py [--root DIR] [--seeds 0 1 2 3 4]

``--root`` is the checkout whose package and chip_smoke.py are used (the
default: this one), so one call can hold two commits: unpack the other
with ``git archive`` into an ignored directory and run both, in turns.
"""
import argparse
import sys
import time
from pathlib import Path

import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("composite_fit_seeds: no CUDA device")
    sys.path.insert(0, args.root)
    import chip_smoke as cs

    cs.phase_device()
    x, y, _, _ = cs._mauna_data(cs.N_MAIN)
    cs._mauna_model().fit(x, y, **dict(cs.FIT_KWARGS, steps=1))  # builds, warms
    for seed in args.seeds:
        t0 = time.perf_counter()
        res = cs._mauna_model().fit(
            x, y, generator=torch.Generator(device="cuda").manual_seed(seed),
            **cs.FIT_KWARGS)
        torch.cuda.synchronize()
        print(f"[{Path(args.root).name}] seed {seed}: "
              f"{time.perf_counter() - t0:.3f} s, skipped share "
              f"{res.diagnostics['frozen_frac']:.1f}, NLL "
              f"{[round(float(v), 1) for v in res.history]}", flush=True)


if __name__ == "__main__":
    main()
