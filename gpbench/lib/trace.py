"""Reading a ``torch.profiler`` run of a short steady stretch: the union of
the device's kernel intervals (busy seconds), the device operations that
took most time, and the device's idle gaps by what the host was doing."""
from __future__ import annotations

import bisect
import time

import torch


def _spans(prof):
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if "user_annotation" not in (e.name or ""):
                dev.append((a, b, e.name))
        else:
            host.append((a, b, e.name))
    return sorted(dev), sorted(host)


def profile(fn) -> dict:
    """Run ``fn`` under the profiler, the device synchronised at both ends;
    return busy and window seconds and the breakdown."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev, host = _spans(prof)
    busy, end, gaps = 0.0, None, []
    by_op = {}
    for a, b, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    idle_by_host = {}
    starts = [h[0] for h in host]
    for a, b in gaps:
        # the innermost host operation running when the device went idle:
        # the latest-starting one that still covers the gap's start
        label = "no host operation"
        i = bisect.bisect_right(starts, a) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if host[j][1] >= a:
                label = host[j][2]
                break
        idle_by_host[label] = idle_by_host.get(label, 0.0) + (b - a) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": window,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in idle]}}
