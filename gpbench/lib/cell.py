"""One run of one cell: the traffic mix's kind (``gpbench/traffic/kinds/
<kind>.py``, found by the mix's ``"kind"``) runs set-up, the measured
window, the traced stretch (with ``trace``) and the check of what the
window produced; the helpers every kind shares are here.

A window is every fit or request started before ``seconds`` have passed;
the one in flight is finished and the window ends with a synchronise, so a
rate is all the work over all the time."""
from __future__ import annotations

import gc
import importlib
import sys
import traceback

import torch

from gpbench.lib import system

GIB = float(1 << 30)


def kind(name: str):
    """The module of traffic kind ``name``: ``run(cell, seed, seconds,
    traced, device, t_start)`` and ``readings(cell, seed, device, control,
    faults)`` (the calibration's)."""
    try:
        return importlib.import_module("gpbench.traffic.kinds." + name)
    except ModuleNotFoundError as e:
        if e.name != "gpbench.traffic.kinds." + name:
            raise
        raise ValueError(f"unknown traffic kind {name!r}: add "
                         f"gpbench/traffic/kinds/{name}.py") from None


def run(cell: dict, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    """The run's result: "correct", "checks", "attempted", "failed",
    "peak" (bytes), "e2e" (end-to-end values by metric name before any
    ``.`` suffix) and "ctx" (what the per-layer metric files read)."""
    system.pin_float32()
    return kind(cell["traffic"]["kind"]).run(cell, seed, seconds, traced,
                                             device, t_start)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak(device) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated()
    return 0


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def fail(failed: list, where: str):
    if not failed:
        print(f"[gpbench] first failure in the window ({where}):",
              file=sys.stderr)
        traceback.print_exc()
    failed.append(where)


def timed_calls(rec, wall: float) -> dict:
    """Least and device seconds per kind of counted call, and the
    preconditioner builds' device milliseconds, read after the window."""
    torch.cuda.synchronize()
    return {"calls": dict(rec.calls), "least": dict(rec.least),
            "device": rec.device_seconds(), "precond_ms": rec.precond_ms()}


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
