"""Faults planted under the timed path, to show that the correctness check
fails them (``gpbench/tests``, ``gpbench/calibrate.py``). Each is a context
manager that patches the program and restores it."""
from __future__ import annotations

import contextlib
import importlib

import torch

ITERATIVE = "gaussianprocessfundamentals_tpu_torch.models.iterative"
EXACT = "gaussianprocessfundamentals_tpu_torch.models.exact"


@contextlib.contextmanager
def _patched(module: str, name: str, fn):
    mod = importlib.import_module(module)
    saved = getattr(mod, name)
    setattr(mod, name, fn(saved))
    try:
        yield
    finally:
        setattr(mod, name, saved)


@contextlib.contextmanager
def state_unchanged():
    """Every optimiser step returns its parameters unchanged."""
    saved = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = saved


def guard_always_skips():
    """Every step guard decides to skip its step."""
    def wrap(inner):
        def guard(nll, *a, **kw):
            inner(nll, *a, **kw)
            return torch.ones((), dtype=torch.bool, device=nll.device)
        return guard
    return _patched(ITERATIVE, "_step_guard", wrap)


def half_batch():
    """The NLL and its gradient over every other row, the mean taken over
    those (scaled back to the whole set)."""
    def wrap(inner):
        def nll_and_grad(kernel, x, y, noise, generator=None, **kw):
            out = list(inner(kernel, x[::2], y[::2], noise, generator, **kw))
            scale = x.shape[0] / x[::2].shape[0]
            out[0] = out[0] * scale
            out[1] = _scaled(out[1], scale)
            out[2] = out[2] * scale
            if len(out) > 4:
                out[4] = _scaled(out[4], scale)
            return tuple(out)
        return nll_and_grad
    return _patched(ITERATIVE, "iterative_nll_and_grad", wrap)


def _scaled(tree, s):
    if isinstance(tree, dict):
        return {k: _scaled(v, s) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_scaled(v, s) for v in tree)
    return tree * s


def altered_answer(rel: float = 0.1):
    """Every answer's posterior mean moved by ``rel`` of the prior standard
    deviation at its points, where it is produced."""
    def wrap(inner):
        def chunked(kernel, x, y, x_test, noise, *a, **kw):
            mu, var = inner(kernel, x, y, x_test, noise, *a, **kw)
            return mu + rel * torch.sqrt(kernel.diag(x_test)), var
        return chunked
    return _patched(EXACT, "iterative_posterior_chunked", wrap)


FIT_FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
              "guard_always_skips": guard_always_skips}
POSTERIOR_FAULTS = {"altered_answer": altered_answer}
