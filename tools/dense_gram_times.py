"""Phase 22 of chip_smoke.py (the dense Gram kernels K5 and K6 at the dense
paths' shapes, each checked against its plain version, then timed: device
time, per-call wall, the Cholesky right after a build) for another
checkout's package, on one GPU, so that two commits can be held side by
side in one call.

    python3 tools/dense_gram_times.py [--root DIR]

``--root`` is the checkout whose ``cuda_dense_gram`` is timed (the default:
this one); the shapes and the timing are this checkout's, and a build that
checkout refuses is reported and skipped. Unpack the other commit with
``git archive`` into an ignored directory and run both in turns: other,
this, this, other.
"""
import argparse
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dense_gram_times: no CUDA device")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    sys.path.insert(0, str(Path(args.root).resolve()))
    from gaussianprocessfundamentals_tpu_torch.ops import cuda_dense_gram as dg

    cs.phase_device()
    cs.phase_k56_time(dg, label=Path(args.root).resolve().name)


if __name__ == "__main__":
    main()
