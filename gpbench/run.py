"""Run one cell of the benchmark once and print its result line.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port
(``gaussianprocessfundamentals_tpu_torch``), on a machine with the NVIDIA
GPUs the cell asks for. The cell, its configuration, traffic mix and
metrics are found by name from ``BENCHMARK.json`` (``gpbench/README.md``).
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. The last line of standard output is
one JSON object; the last lines of standard error are the numbers the
correctness check compared, each beside its limit.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "gaussianprocessfundamentals_tpu")


def loaded_forbidden() -> list:
    """Modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(cell: dict, out: dict, traced: bool, device_info: dict) -> dict:
    metrics = {}
    if traced:
        ctx = dict(out["ctx"])
        for m in cell["per_layer"]:
            v = cell["readers"][m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        prof = out["ctx"].get("profile")
        if prof:
            device_info["busy_s"] = prof["busy_s"]
            device_info["window_s"] = prof["window_s"]
    else:
        # a suffix after the first "." names the cells, not the quantity
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": out["e2e"][m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    if traced and out["ctx"].get("profile"):
        line["breakdown"] = out["ctx"]["profile"]["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpbench.lib import spec

    cell = spec.cell(spec.benchmark(ROOT / "BENCHMARK.json"), args.workload)
    chips = cell["workload"]["chips"]

    import torch

    # one process, one host thread: the host's share of the work stays steady
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[gpbench] needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 3

    from gpbench.lib import cell as cell_run

    out = cell_run.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                       T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"[gpbench] JAX or the JAX package was loaded: {bad}: no result",
              file=sys.stderr)
        return 4
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": chips, "memory_peak_bytes": int(out["peak"])}
    line = result_line(cell, out, bool(args.trace), device_info)
    for name, c in out["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"[check] correct {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
