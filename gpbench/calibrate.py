"""Readings that set the correctness limits of a cell (not run by the
benchmark's runs): for each seed, the program's numbers against the
float64 reference, and with ``--control`` the lower-precision control's
(the reference itself in float32 with TF32 matmuls, in the program's
place), and with ``--faults`` the numbers of each planted fault; each
traffic kind takes its readings (``traffic/kinds/<kind>.py``).

    python3 gpbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control] [--faults] [--out FILE]

One JSON line per seed and reading on standard output, also appended to
``FILE`` when given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="a file to append the JSON lines to")
    args = ap.parse_args(argv)

    from gpbench.lib import cell as cell_run
    from gpbench.lib import spec, system

    cell = spec.cell(spec.benchmark(ROOT / "BENCHMARK.json"), args.workload)
    system.pin_float32()
    kind = cell_run.kind(cell["traffic"]["kind"])
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        for name, numbers in kind.readings(cell, seed, args.device,
                                           args.control, args.faults):
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "reading": name, **numbers,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
