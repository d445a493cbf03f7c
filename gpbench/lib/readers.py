"""What the per-layer metric files read from a run: the profiled stretch,
the counted calls of the window and their CUDA-event times. Each returns
None where the run has nothing to read, never 0 for a share."""
from __future__ import annotations

import numpy as np


def idle_percent(ctx):
    prof = ctx.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def mfu_percent(ctx):
    """Σ least seconds of the window's counted calls / the window's wall."""
    least = ctx.get("least")
    if not least or ctx["wall"] <= 0:
        return None
    total = sum(least.values())
    return 100.0 * total / ctx["wall"] if total > 0 else None


def roofline_percent(ctx, kind: str):
    """Σ least seconds / Σ device seconds of the window's calls of ``kind``."""
    lt, dt = (ctx.get("device") or {}).get(kind, (0.0, 0.0))
    return 100.0 * lt / dt if lt > 0 and dt > 0 else None


def precond_ms(ctx):
    ms = ctx.get("precond_ms")
    return float(np.mean(ms)) if ms else None


def cg_iters(ctx):
    it = ctx.get("cg_iters")
    return float(np.mean(it)) if it else None
