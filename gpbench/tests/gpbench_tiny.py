"""Shared helpers of the benchmark's CPU tests: the cells at a tiny size,
through the tests' own small configurations (``data/configs``), with the
port's size thresholds lowered so that the tiny problems take the same
iterative route that N = 100,000 takes."""
from __future__ import annotations

import contextlib
import importlib
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"se-100k": "se-tiny", "mauna-100k": "mauna-tiny"}
THRESHOLDS = (
    ("gaussianprocessfundamentals_tpu_torch.fit.fit", "_AUTO_ITERATIVE_N"),
    ("gaussianprocessfundamentals_tpu_torch.models.iterative",
     "_MATERIALIZE_MAX_N"),
    ("gaussianprocessfundamentals_tpu_torch.models.exact",
     "_AUTO_ITERATIVE_POST_N"),
)


@contextlib.contextmanager
def iterative_route():
    saved = []
    for mod, name in THRESHOLDS:
        m = importlib.import_module(mod)
        saved.append((m, name, getattr(m, name)))
        setattr(m, name, 0)
    try:
        yield
    finally:
        for m, name, v in saved:
            setattr(m, name, v)


def tiny_cell(workload: str) -> dict:
    from gpbench.lib import spec

    bench = spec.benchmark()
    for w in bench["workloads"]:
        w["config"] = TINY[w["config"]]
    return spec.cell(bench, workload, config_root=HERE / "data")


def run_tiny(workload: str, seed: int, seconds: float = 1.0) -> dict:
    from gpbench.lib import cell

    with iterative_route():
        return cell.run(tiny_cell(workload), seed, seconds, False, "cpu",
                        time.perf_counter())
