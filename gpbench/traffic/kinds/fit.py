"""``{"kind": "fit", "steps": k}``: back-to-back ``GaussianProcess.fit``
calls of k Adam steps each on the whole training set, each from the
configuration's starting point with its probes from its own seed.

Set-up runs the cell's own fit call 0 for the check's steps, recorded
(:func:`record_fit`); the reference follows them once the window has
closed. End to end: ``fit_step_s``, the window's wall over all the steps
completed in it."""
from __future__ import annotations

import time

import numpy as np

from gpbench.lib import cell as common
from gpbench.lib import check, faults as fault_mod, instrument, system, trace

CHECK_STEPS = 3  # fit steps the reference follows


def fit_kwargs(cfg: dict, steps: int, seed: int, call: int, device) -> dict:
    f = cfg["fit"]
    return dict(method=f["method"], optimize_noise=f["optimize_noise"],
                noise=f["noise"], lr=f["lr"], steps=steps,
                iterative_kwargs=dict(f["iterative_kwargs"]),
                generator=system.generator(system.seed_for(seed, "probes", call),
                                           device))


def record_fit(cfg, gp, x, y, seed, device, rec) -> dict:
    """Fit call 0 of the seed, ``CHECK_STEPS`` steps, with the wrappers of
    ``rec`` installed: its NLL per step, its first gradient before the step
    guard and as the optimiser gets it, its result, each step's
    preconditioner basis with the parameters it was built at, and what each
    step guard read and decided."""
    rec.record_bases, rec.record_guard = [], []
    with instrument.FirstGrads() as fg:
        res = gp.fit(x, y, **fit_kwargs(cfg, CHECK_STEPS, seed, 0, device))
    common.sync(device)
    guard = rec.record_guard
    record = {"nll": [float(v) for v in res.history], "res": res,
              "first_grads": fg.grads,
              "first_raw": guard[0]["grads"] if guard else None,
              "bases": rec.record_bases,
              "resid_median": [g["median"] for g in guard],
              "finite": [g["finite"] for g in guard],
              "skipped": [g["skipped"] for g in guard]}
    rec.record_bases = rec.record_guard = None
    return record


def recorded(cfg, x, y, seed, device) -> dict:
    """:func:`record_fit` on a new model, with the wrappers installed for
    it alone (over whatever fault is planted underneath)."""
    rec = instrument.Recorder()
    undo = instrument.install(rec)
    try:
        return record_fit(cfg, system.build_gp(cfg, device, with_params=False),
                          x, y, seed, device, rec)
    finally:
        undo()


def run(cell, seed, seconds, traced, device, t_start):
    cfg, mix = cell["config"], cell["traffic"]
    x, y = system.make_data(cfg, seed, device)
    gp = system.build_gp(cfg, device, with_params=False)
    rec = instrument.Recorder()
    undo = instrument.install(rec)
    try:
        # set-up: the cell's own fit call drives the model from the seed
        # through its first steps (the check follows them), warming every
        # shape
        record = record_fit(cfg, gp, x, y, seed, device, rec)
        if not traced:
            undo()
        setup_peak = common.peak(device)
        setup_s = time.perf_counter() - t_start
        common.reset_peak(device)
        rec.reset()
        rec.timing = traced

        steps, attempted, failed, frozen = mix["steps"], 0, [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            attempted += 1
            try:
                r = gp.fit(x, y, **fit_kwargs(cfg, steps, seed, attempted,
                                              device))
                if not all(np.isfinite(float(v)) for v in r.history):
                    failed.append(f"fit {attempted}: non-finite NLL")
                frozen.append(r.diagnostics.get("frozen_frac", 0.0))
            except Exception:  # a failed fit counts against the run
                common.fail(failed, f"fit {attempted}")
        common.sync(device)
        wall = time.perf_counter() - t0
        window_peak = common.peak(device)
        done = attempted - len(failed)
        out = {"attempted": attempted, "failed": len(failed),
               "peak": max(window_peak, setup_peak),
               "e2e": {"setup_s": setup_s,
                       "fit_step_s": (wall / (done * steps) if done
                                      else float("nan")),
                       "peak_device_gib": window_peak / common.GIB},
               "ctx": {"wall": wall, "steps": done * steps, "frozen": frozen}}
        if traced:
            out["ctx"].update(common.timed_calls(rec, wall))
            rec.timing = False
            out["ctx"]["profile"] = trace.profile(lambda: gp.fit(
                x, y, **fit_kwargs(cfg, steps, seed, attempted + 1, device)))
    finally:
        undo()
    del gp
    common.free(device)
    numbers = check.fit_numbers(cfg, x, y, seed, record)
    out["correct"], out["checks"] = check.verdict(numbers, cfg["limits"]["fit"])
    return out


def readings(cell, seed, device, control, faults):
    """[(name, numbers)]: the program's fit numbers on this seed, with
    ``faults`` each planted fault's, with ``control`` the lower-precision
    control's (the reference in float32 with TF32 matmuls, deciding its
    own steps, in the program's place)."""
    import torch

    cfg = cell["config"]
    system.pin_float32()
    x, y = system.make_data(cfg, seed, device)
    record = recorded(cfg, x, y, seed, device)
    fault_records = {}
    for name in (fault_mod.FIT_FAULTS if faults else ()):
        if name == "state_unchanged":
            continue  # reads 1 on change_gap by its measure: no run needed
        with fault_mod.FIT_FAULTS[name]():
            fault_records[name] = recorded(cfg, x, y, seed, device)
    common.free(device)
    guard = cfg["fit"]["resid_guard"]
    want = check.reference_fit(cfg, x, y, seed, record)
    want["tr"] = check.basis_traces(cfg, x, record)
    out = [("program", {
        **check.fit_gaps(check.program_fit(cfg, record), want, guard),
        "skipped": record["skipped"], "resid_median": record["resid_median"],
        "ref_skipped": want["skipped"],
        "ref_resid_median": want["resid_median"]})]
    for name, r in fault_records.items():
        # against the reference of the sound call: a fault's own record may
        # not be one the reference can follow (half_batch's bases)
        out.append((name, check.fit_gaps(check.program_fit(cfg, r), want,
                                         guard)))
    if control:
        with check.tf32_matmuls():
            got = check.reference_fit(cfg, x, y, seed, record,
                                      dtype=torch.float32, defer=False)
        out.append(("control_tf32", check.fit_gaps(got, want, guard)))
    return out
