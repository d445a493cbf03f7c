"""Find a cell's configuration, traffic mix and metric readers by the
names ``BENCHMARK.json`` gives them: a configuration is
``configs/<name>.json``, a traffic mix ``traffic/<name>.json`` and a
per-layer metric ``metrics/<name>.py`` under the benchmark's folder. A new
cell, configuration, mix or metric is a new file and an entry in
``BENCHMARK.json``; nothing here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = None) -> dict:
    return load_json(path or ROOT.parent / "BENCHMARK.json")


def config(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "traffic" / f"{name}.json")


def metric_reader(name: str, root: Path = ROOT):
    """The module ``metrics/<name>.py``: ``LAYER``, ``UNIT``, ``MOVES`` and
    ``read(ctx) -> float | None`` (None: nothing to read in this run)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, workload: str, root: Path = ROOT,
         config_root: Path = None) -> dict:
    """Everything one run of ``workload`` needs: its entry, configuration
    (from ``config_root``, the benchmark's own folder unless a test gives
    another), traffic mix, end-to-end metrics and per-layer metric
    readers."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(entries)}")
    w = entries[workload]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if applies(m) and m["moves"] in names]
    return {"workload": w, "config": config(w["config"], config_root or root),
            "traffic": traffic(w["traffic"], root), "end_to_end": e2e,
            "per_layer": layer,
            "readers": {m["name"]: metric_reader(m["name"], root)
                        for m in layer}}
