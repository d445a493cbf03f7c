"""Show that chip_smoke.py phase 29's gates can fail: the same problem and
draws (example 06 at N = 20,000, Matérn-5/2~s, 64 paths, D = 2,048) with
the Matheron update term left out, so that the "samples" are the RFF
prior draws at the test points, held to ``chip_smoke.pathwise_gates``
against the float64 dense posterior.

    python3 tools/pathwise_gate_check.py

Prints the gates' readings; exits 0 when the gates fail, as they must,
and 1 when they pass. Without a GPU it fails.
"""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("pathwise_gate_check: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from gaussianprocessfundamentals_tpu_torch.models import rff

    cs.phase_device()
    kernel, x, y, xt, mu, var = cs._pathwise_problem()
    gen = torch.Generator(device="cuda").manual_seed(29)
    with torch.no_grad():
        state = rff.rff_init(kernel, 1, cs.D_PW, gen)
        prior = rff.rff_prior_sample(state, xt, gen, cs.S_PW)
    gates = cs.pathwise_gates(prior, mu, var)
    print(f"[pathwise-check] update term left out, {cs.S_PW} prior draws at "
          f"{cs.T_PW} points: max|mean - mu| / (sd/8) {gates['mean_z']:.3f}, "
          f"/ its limit {gates['mean_excess']:.3f}; sample var / var min "
          f"{gates['ratio_min']:.3f} max {gates['ratio_max']:.3f} mean "
          f"{gates['ratio_mean']:.3f}: gates "
          f"{'pass (WRONG)' if gates['ok'] else 'fail, as they must'}",
          flush=True)
    sys.exit(1 if gates["ok"] else 0)


if __name__ == "__main__":
    main()
