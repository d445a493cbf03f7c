"""Counts and device times taken at the program's layer boundaries, from
the benchmark's own files: the routers that hand the Gram·V products, the
low-rank VJP and the Gram builds to the kernels, and the preconditioner
build, are replaced in the module that calls them by wrappers that count
each logical call's work (:mod:`.work`) and, when timing is on, bracket it
with CUDA events. While a fit call is recorded for the check, each step's
preconditioner basis with the parameters it was built at, and the step
guard's inputs, its decision and the gradient it was handed are kept.
Outside a recorded fit nothing here synchronises the device. The wrappers are installed for the
recorded set-up fit and for traced runs only."""
from __future__ import annotations

import torch

from gpbench.lib import work

ITERATIVE = "gaussianprocessfundamentals_tpu_torch.models.iterative"


class Recorder:
    """Per-kind sums of calls and least seconds; with ``timing`` on, the
    CUDA events of each call, read once the window has closed."""

    def __init__(self):
        self.timing = False
        self.calls = {}
        self.least = {}
        self.events = []  # (kind, least seconds, start event, end event)
        self.precond_events = []
        # lists while a fit call is recorded for the check: each step's
        # preconditioner (W_b, sv, kernel parameters, noise), and what its
        # step guard read and decided
        self.record_bases = None
        self.record_guard = None

    def reset(self):
        self.calls, self.least, self.events, self.precond_events = {}, {}, [], []

    def _event(self):
        return torch.cuda.Event(enable_timing=True)

    def call(self, kind, least, fn, *args):
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.least[kind] = self.least.get(kind, 0.0) + least
        if not self.timing:
            return fn(*args)
        a, b = self._event(), self._event()
        a.record()
        out = fn(*args)
        b.record()
        self.events.append((kind, least, a, b))
        return out

    def device_seconds(self) -> dict:
        """{kind: (least seconds, device seconds)} over the timed calls."""
        out = {}
        for kind, least, a, b in self.events:
            lt, dt = out.get(kind, (0.0, 0.0))
            out[kind] = (lt + least, dt + 1e-3 * a.elapsed_time(b))
        return out

    def precond_ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.precond_events]


def _desc(kernel) -> dict:
    return kernel.to_dict()


def _rank(V) -> int:
    return 1 if V.ndim == 1 else V.shape[1]


def install(rec: Recorder):
    """Wrap the routers and the preconditioner build where
    ``models.iterative`` calls them; returns a function that undoes it."""
    import importlib

    it = importlib.import_module(ITERATIVE)
    saved = {name: getattr(it, name) for name in (
        "fused_matvec_for", "fused_matvec_cross_for", "fused_lowrank_vjp_for",
        "dense_gram_for", "build_preconditioner", "_step_guard")}

    def matvec_cross_for(kernel, x1, x2, *a, **kw):
        inner = saved["fused_matvec_cross_for"](kernel, x1, x2, *a, **kw)
        desc, sym = _desc(kernel), x1 is x2

        def mv(V):
            lt = work.least_time("gram_matvec", desc, x1.shape[0], x2.shape[0],
                                 _rank(V), x1.shape[1], sym)
            return rec.call("gram_matvec", lt, inner, V)
        return mv

    def matvec_for(kernel, x):
        inner = saved["fused_matvec_for"](kernel, x)
        desc = _desc(kernel)

        def mv(V):
            lt = work.least_time("gram_matvec", desc, x.shape[0], x.shape[0],
                                 _rank(V), x.shape[1], True)
            return rec.call("gram_matvec", lt, inner, V)
        return mv

    def vjp_for(kernel, x):
        inner = saved["fused_lowrank_vjp_for"](kernel, x)
        desc = _desc(kernel)

        def vjp(U, W):
            lt = work.least_time("lowrank_vjp", desc, x.shape[0], x.shape[0],
                                 U.shape[1], x.shape[1], True)
            return rec.call("lowrank_vjp", lt, inner, U, W)
        return vjp

    def gram_for(kernel, x1, x2, *a, **kw):
        lt = work.least_time("dense_gram", _desc(kernel), x1.shape[0],
                             x2.shape[0], 0, x1.shape[1], x1 is x2)
        return rec.call("dense_gram", lt, saved["dense_gram_for"], kernel, x1,
                        x2, *a, **kw)

    def precond(kernel, x, m, noise):
        if rec.timing:
            a, b = rec._event(), rec._event()
            a.record()
        out = saved["build_preconditioner"](kernel, x, m, noise)
        if rec.timing:
            b.record()
            rec.precond_events.append((a, b))
        if rec.record_bases is not None:
            _, W_b, sv, _, _ = out
            params = _detached(kernel.get_params())
            rec.record_bases.append((W_b.detach().clone(), sv.detach().clone(),
                                     params, torch.as_tensor(noise).detach()
                                     .clone()))
        return out

    def guard(nll, g_u, resid, resid_guard, *a, **kw):
        bad = saved["_step_guard"](nll, g_u, resid, resid_guard, *a, **kw)
        if rec.record_guard is not None:
            grads = [g.detach().clone() for g in it.tree_leaves(g_u)]
            finite = (all(bool(torch.isfinite(g).all()) for g in grads)
                      and bool(torch.isfinite(nll).all())
                      and bool(torch.isfinite(resid).all()))
            rec.record_guard.append({
                "median": float(torch.quantile(resid.detach(), 0.5)),
                "finite": finite, "skipped": bool(bad), "grads": grads})
        return bad

    it._step_guard = guard
    it.fused_matvec_for = matvec_for
    it.fused_matvec_cross_for = matvec_cross_for
    it.fused_lowrank_vjp_for = vjp_for
    it.dense_gram_for = gram_for
    it.build_preconditioner = precond

    def undo():
        for name, fn in saved.items():
            setattr(it, name, fn)
    return undo


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_detached(v) for v in tree)
    return tree.detach().clone()


class FirstGrads:
    """The gradients as the optimiser gets them at its first step, read by a
    global optimiser pre-hook while installed."""

    def __init__(self):
        self.grads = None
        self._handle = None

    def __enter__(self):
        from torch.optim.optimizer import register_optimizer_step_pre_hook

        def hook(opt, args, kwargs):
            if self.grads is None:
                self.grads = [p.grad.detach().clone()
                              for g in opt.param_groups for p in g["params"]]
        self._handle = register_optimizer_step_pre_hook(hook)
        return self

    def __exit__(self, *exc):
        self._handle.remove()
