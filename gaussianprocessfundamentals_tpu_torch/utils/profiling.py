"""Profiling and telemetry: a ``torch.profiler`` trace, labelled ranges,
timers and a per-step logger.

Counterpart of ``gaussianprocessfundamentals_tpu/utils/profiling.py``:
``trace`` (``:27``) records with ``torch.profiler`` and writes a Chrome
trace (ui.perfetto.dev opens it); ``named_scope`` labels a range in it;
``timed`` (``:43``) synchronises CUDA on both sides of its block;
``StepLogger`` (``:50``) is unchanged; ``enable_debug_checks`` (``:73``)
turns on autograd's anomaly mode, which raises where a backward pass
makes a NaN. The JAX package's persistent compilation cache has no
counterpart: the port compiles no programs.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Optional

import torch

log = logging.getLogger("gpf_torch")

named_scope = torch.profiler.record_function


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(profile_dir: Optional[str] = None):
    """Profile the enclosed block (CPU, and CUDA where a card is in use)
    when ``profile_dir`` is set: yields the ``torch.profiler.profile``
    (``key_averages()`` for sums by op and kernel) and writes
    ``profile_dir/trace.json`` on exit. Yields None without a directory."""
    if not profile_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


@contextlib.contextmanager
def timed(label: str):
    """Log the wall time of the block, the device's queued work included."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    log.info("%s took %.3fs", label, time.perf_counter() - t0)


class StepLogger:
    """Structured per-step fit telemetry: JSON lines of
    {step, loss, grad_norm, dt}."""

    def __init__(self, every: int = 10, sink=None):
        self.every = every
        self.sink = sink or (lambda s: log.info("%s", s))
        self._t = time.perf_counter()

    def __call__(self, step: int, loss: float,
                 grad_norm: Optional[float] = None):
        if step % self.every:
            return
        now = time.perf_counter()
        rec = {"step": step, "loss": float(loss), "dt": now - self._t}
        if grad_norm is not None:
            rec["grad_norm"] = float(grad_norm)
        self._t = now
        self.sink(json.dumps(rec))


def enable_debug_checks(nans: bool = True) -> None:
    """Autograd's anomaly mode: a backward pass that makes a NaN raises,
    naming the forward op."""
    torch.autograd.set_detect_anomaly(nans)
