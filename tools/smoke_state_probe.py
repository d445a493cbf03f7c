"""Phases 28 and 30 of ``chip_smoke.py`` inside the smoke and alone, on one
GPU, in one process.

    python3 tools/smoke_state_probe.py [--alone]

Two calls, at the smoke's settings: phase 28's SVGP fit (``fit_svgp`` of
SE~s at N = 100,000, m = 512, batch 4,096, lr 1e-2, 3,000 Adam steps in
float32) and phase 30's kernel search (``greedy_kernel_search`` on the
Mauna Loa record at max_depth 2, 1 restart, 150 steps, float64). Each is
timed first alone (after ``phase_device`` and a warm-up), then after the
smoke's phases 1-27, run in the smoke's order. After every phase a short
probe of each (300 SVGP steps; the search at max_depth 0) says after which
phase they slow down. Each reading comes with the process's state: its
threads, the Python objects the garbage collector tracks, the time spent
in collections during the call, and the card memory reserved. Then the
full-size calls again after ``gc.freeze()``, and last, alone once more in
a fresh process (``--alone``: only the alone readings), so that a drift
of the host between the first and the last reading shows.

One line per reading, and a JSON summary as the last line (also written
to ``chiprun_out/smoke_state_probe.json``).
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
PROBE_STEPS = 300


class GCTimer:
    """Wall time spent in the garbage collector between ``start`` and
    ``stop`` (``gc.callbacks``), and the collections per generation."""

    def __init__(self):
        self.total, self.count, self._t0, self.on = 0.0, [0, 0, 0], None, False
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if not self.on:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.total += time.perf_counter() - self._t0
            self.count[info["generation"]] += 1
            self._t0 = None

    def start(self):
        self.total, self.count, self.on = 0.0, [0, 0, 0], True

    def stop(self):
        self.on = False
        return self.total, list(self.count)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--alone", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("smoke_state_probe: no CUDA device")
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    import gaussianprocessfundamentals_tpu_torch as gpt

    gct = GCTimer()
    readings = []

    def state() -> dict:
        return {"threads": len(os.listdir("/proc/self/task")),
                "gc_tracked": len(gc.get_objects()),
                "reserved_gb": torch.cuda.memory_reserved() / 1e9}

    def svgp(steps: int) -> float:
        x, y = cs.svgp_data(cs.N_SVGP)
        kernel = gpt.SquaredExponentialKernel(scaled=True).cuda()
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpt.fit_svgp(kernel, x, y, m=cs.M_SVGP, generator=gen,
                     batch_size=cs.B_SVGP, steps=steps, lr=1e-2)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def search(depth: int) -> float:
        x, y, _, _ = cs._mauna_csv()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpt.greedy_kernel_search(
            x, y, max_depth=depth, seed=0,
            fit_kwargs={"steps": cs.SEARCH_STEPS,
                        "restarts": cs.SEARCH_RESTARTS,
                        "optimize_noise": True})
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def read(where: str, what: str, fn, *args) -> None:
        gct.start()
        wall = fn(*args)
        gc_s, gens = gct.stop()
        rec = dict(where=where, what=what, wall_s=wall, gc_s=gc_s,
                   collections=gens, **state())
        readings.append(rec)
        cs.log(f"[probe] {where}: {what} {wall:.3f} s (gc {gc_s:.3f} s in "
               f"{gens} collections; threads {rec['threads']}, gc-tracked "
               f"{rec['gc_tracked']}, reserved {rec['reserved_gb']:.2f} GB)")

    def probes(where: str) -> None:
        read(where, f"svgp {PROBE_STEPS} steps", svgp, PROBE_STEPS)
        read(where, "search depth 0", search, 0)

    smi = cs.phase_device()
    svgp(50)  # the first fit of a process pays one-time imports
    read("alone", f"svgp {cs.SVGP_STEPS} steps", svgp, cs.SVGP_STEPS)
    read("alone", f"search depth {cs.SEARCH_DEPTH}", search, cs.SEARCH_DEPTH)
    if args.alone:
        print(json.dumps(readings), flush=True)
        return
    probes("alone")

    fit_res = expr_fit = seg = None

    def fit():
        nonlocal fit_res
        fit_res = cs.phase_fit()

    def expr():
        nonlocal expr_fit
        expr_fit = cs.phase_expr_fit()

    def segmented():
        nonlocal seg
        seg = cs.phase_segmented()

    phases = [
        ("phase_build", cs.phase_build),
        ("phase_kernel_check", cs.phase_kernel_check),
        ("phase_oracle", cs.phase_oracle),
        ("phase_main", cs.phase_main),
        ("phase_plain_functions", cs.phase_plain_functions),
        ("phase_k2_check", cs.phase_k2_check),
        ("phase_fit_oracle", cs.phase_fit_oracle),
        ("phase_fit", fit),
        ("phase_fit_time", lambda: cs.phase_fit_time(fit_res["x"])),
        ("phase_profile",
         lambda: cs.phase_profile(fit_res["x"], fit_res["y"])),
        ("phase_k3_check", cs.phase_k3_check),
        ("phase_k4_check", cs.phase_k4_check),
        ("phase_expr_oracle", cs.phase_expr_oracle),
        ("phase_expr_fit", expr),
        ("phase_expr_serve", lambda: cs.phase_expr_serve(expr_fit)),
        ("phase_expr_time", lambda: cs.phase_expr_time(expr_fit["x"])),
        ("expr-profile", lambda: cs._profile_step(
            cs._mauna_model, expr_fit["x"], expr_fit["y"], "expr-profile")),
        ("phase_k56_check", cs.phase_k56_check),
        ("phase_dense_serve", cs.phase_dense_serve),
        ("phase_segmented", segmented),
        ("phase_partitioned",
         lambda: cs.phase_partitioned(seg.pop("segments"))),
        ("phase_k56_time", cs.phase_k56_time),
        ("phase_changepoint", cs.phase_changepoint),
        ("phase_var_gate", cs.phase_var_gate),
        ("phase_story_200k", cs.phase_story_200k),
        ("phase_nystroem", cs.phase_nystroem),
        ("phase_skc_ski", cs.phase_skc_ski),
    ]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        cs.log(f"[probe] {name} ran in {time.perf_counter() - t0:.1f} s")
        probes(f"after {name}")

    read("inside", f"svgp {cs.SVGP_STEPS} steps", svgp, cs.SVGP_STEPS)
    read("inside", f"search depth {cs.SEARCH_DEPTH}", search, cs.SEARCH_DEPTH)
    gc.collect()
    gc.freeze()
    read("inside, gc.freeze()", f"svgp {cs.SVGP_STEPS} steps", svgp,
         cs.SVGP_STEPS)
    read("inside, gc.freeze()", f"search depth {cs.SEARCH_DEPTH}", search,
         cs.SEARCH_DEPTH)
    probes("inside, gc.freeze()")
    again = subprocess.run([sys.executable, __file__, "--alone"],
                           capture_output=True, text=True, check=True)
    for rec in json.loads(again.stdout.strip().splitlines()[-1]):
        rec["where"] = "alone, a fresh process at the end"
        readings.append(rec)
        cs.log(f"[probe] {rec['where']}: {rec['what']} {rec['wall_s']:.3f} s")

    out = {"device": smi, "readings": readings}
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "smoke_state_probe.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
