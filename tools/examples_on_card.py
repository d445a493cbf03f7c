"""Run the port's seven single-process example scripts (01, 02, 04, 06,
07, 08, 10 in ``examples/torch/``) once each at their defaults on one GPU,
through their command lines, in one process, and count the hand-written
kernels each launches.

    python3 tools/examples_on_card.py [stem ...]

Builds the kernels first (``chip_smoke.phase_build``: one nvcc for each
library, all started together), so no script's wall time holds a build.
Each script runs as ``python examples/torch/<stem>.py`` would run it (its
``__main__`` block with no arguments, so ``--device cuda`` and every size
at its default) and prints its own numbers; around it this tool sets the
six kernels' launch counts to 0, reads them after, and times the script
on the host clock, ending in ``torch.cuda.synchronize()``. The first
script also pays the process's one-time imports inside PyTorch (~8 s on
the first fit). Prints the card's name and power limit, one line per
script and a JSON object last; writes it to
``chiprun_out/examples_on_card.json`` too. Without a GPU it fails.
"""
import json
import runpy
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

STEMS = ("01_exact_gp", "02_mauna_loa_composite", "04_svgp_large",
         "06_pathwise_sampling", "07_kernel_search", "08_approx_fit",
         "10_kernel_search_mauna")


def main(stems) -> None:
    smi = cs.phase_device()
    cs.phase_build()
    out = {"device": smi, "scripts": {}}
    for stem in stems:
        path = ROOT / "examples" / "torch" / f"{stem}.py"
        argv, sys.argv = sys.argv, [str(path)]
        cs.log(f"[example] {stem} at its defaults:")
        cs._zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            runpy.run_path(str(path), run_name="__main__")
            torch.cuda.synchronize()
        finally:
            sys.argv = argv
        wall = time.perf_counter() - t0
        counts = cs._launch_counts()
        out["scripts"][stem] = {"wall_s": wall, "launches": counts}
        cs.log(f"[example] {stem}: wall {wall:.3f} s, launches {counts}")
    cs.log(smi)
    text = json.dumps(out)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "examples_on_card.json").write_text(text + "\n")
    print(text, flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or STEMS)
