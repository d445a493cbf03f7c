"""``{"kind": "posterior", "sizes": [...] | "loguniform": {...}, "low",
"high", "profile_requests"}``: a closed loop of one client asking
``GaussianProcess.posterior`` at batches of test points drawn uniformly
from [low, high], the request sizes walked as :mod:`gpbench.lib.traffic`
orders them, at the configuration's serving hyperparameters.

End to end: ``posterior_points_per_s``, all test points of all requests
completed in the window over its wall, and ``posterior_p90_s``, the 90th
percentile of the requests' latencies (issue to the synchronise after the
result). The check compares a sample of the window's answers, drawn from
the seed, with the reference's exact posterior."""
from __future__ import annotations

import time

import numpy as np
import torch

from gpbench.lib import cell as common
from gpbench.lib import check, faults as fault_mod, instrument, system, trace
from gpbench.lib.traffic import Requests

CHECK_POINTS = 64  # test points the check compares


def _model(cfg, seed, device):
    x, y = system.make_data(cfg, seed, device)
    gp = system.build_gp(cfg, device, with_params=True)
    gp.set_data(x, y)
    return gp, x, y


def run(cell, seed, seconds, traced, device, t_start):
    cfg, mix = cell["config"], cell["traffic"]
    gp, x, y = _model(cfg, seed, device)
    # set-up: one request at the smallest and one at the largest size
    warm = Requests(mix, seed, device, x.shape[1], tag="warm-up")
    for size in sorted({min(warm.order), max(warm.order)}):
        gp.posterior(torch.rand(size, x.shape[1], generator=warm.g,
                                device=device))
    common.sync(device)
    setup_peak = common.peak(device)
    setup_s = time.perf_counter() - t_start
    common.reset_peak(device)
    rec = instrument.Recorder()
    undo = instrument.install(rec) if traced else (lambda: None)
    rec.timing = traced
    try:
        reqs = Requests(mix, seed, device, x.shape[1])
        results, lat, iters, failed, attempted, points = [], [], [], [], 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            attempted += 1
            xt = reqs.next()
            t_issue = time.perf_counter()
            try:
                post = gp.posterior(xt)
                common.sync(device)
                lat.append(time.perf_counter() - t_issue)
                if not bool(torch.isfinite(post.mean).all()
                            & torch.isfinite(post.var).all()):
                    failed.append(f"request {attempted}: non-finite")
                    continue
                results.append((xt, post.mean, post.var))
                iters += list(post.solve_stats["iters"])
                points += xt.shape[0]
            except Exception:  # a failed request counts against the run
                common.fail(failed, f"request {attempted}")
        common.sync(device)
        wall = time.perf_counter() - t0
        window_peak = common.peak(device)
        out = {"attempted": attempted, "failed": len(failed),
               "peak": max(window_peak, setup_peak),
               "e2e": {"setup_s": setup_s,
                       "posterior_points_per_s": points / wall,
                       "posterior_p90_s": (float(np.percentile(lat, 90))
                                           if lat else float("nan")),
                       "peak_device_gib": window_peak / common.GIB},
               "ctx": {"wall": wall, "requests": len(lat), "points": points,
                       "cg_iters": iters}}
        if traced:
            out["ctx"].update(common.timed_calls(rec, wall))
            rec.timing = False

            def stretch():
                for _ in range(mix["profile_requests"]):
                    gp.posterior(reqs.next())
            out["ctx"]["profile"] = trace.profile(stretch)
    finally:
        undo()
    del gp
    common.free(device)
    if results:
        xs, mu, var = check.sample_points(results, seed, CHECK_POINTS)
        numbers = check.posterior_numbers(cfg, x, y, xs, mu, var)
        out["correct"], out["checks"] = check.verdict(
            numbers, cfg["limits"]["posterior"])
    else:
        out["correct"], out["checks"] = False, {}
    return out


def readings(cell, seed, device, control, faults):
    """[(name, numbers)]: the program's posterior numbers on this seed's
    requests (as many points as four checks take), with ``faults`` each
    planted fault's, with ``control`` the lower-precision control's (the
    reference in float32 with TF32 matmuls in the program's place)."""
    cfg, mix = cell["config"], cell["traffic"]
    system.pin_float32()
    gp, x, y = _model(cfg, seed, device)

    def serve(reqs):
        results, points = [], 0
        while points < 4 * CHECK_POINTS:
            xt = reqs.next()
            post = gp.posterior(xt)
            results.append((xt, post.mean, post.var))
            points += xt.shape[0]
        return results

    results = serve(Requests(mix, seed, device, x.shape[1]))
    fault_results = {}
    for name in (fault_mod.POSTERIOR_FAULTS if faults else ()):
        with fault_mod.POSTERIOR_FAULTS[name]():
            fault_results[name] = serve(Requests(mix, seed, device, x.shape[1]))
    del gp
    common.free(device)
    xs, mu, var = check.sample_points(results, seed, CHECK_POINTS)
    want = check.posterior_reference(cfg, x, y, xs)
    out = [("program", check.posterior_numbers(cfg, x, y, xs, mu, var,
                                                want=want))]
    for name, r in fault_results.items():
        _, fmu, fvar = check.sample_points(r, seed, CHECK_POINTS)
        out.append((name, check.posterior_numbers(cfg, x, y, xs, fmu, fvar,
                                                   want=want)))
    if control:
        with check.tf32_matmuls():
            cmu, cvar, _ = check.posterior_reference(cfg, x, y, xs,
                                                     dtype=torch.float32)
        out.append(("control_tf32", check.posterior_numbers(
            cfg, x, y, xs, cmu, cvar, want=want)))
    return out
