"""Kernel composition operators of the PyTorch port: Sum, Product and
ChangePoint.

Counterpart of ``gaussianprocessfundamentals_tpu/kernels/operators.py``
(``Operator``, ``Sum``, ``Product`` at ``:27-101``; ``_gate_before``,
``changepoint_weights`` and ``ChangePoint`` at ``:104-264``). An operator
holds its children as submodules, so ``.to(device)`` moves every leaf's
hyperparameters; its params tree is ``{"children": (p0, p1, ...)}``, the
JAX package's pytree, and each child module holds its own. A ChangePoint
also holds its ``locations`` (``{"children": …, "locations": [k]}``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gaussianprocessfundamentals_tpu_torch.config import (
    DEFAULT_CONFIG,
    ChangePointGate,
)
from gaussianprocessfundamentals_tpu_torch.kernels.base import (
    ChildParams,
    Kernel,
    LocatedChildParams,
    _as_xrange,
    register_kernel,
)


class Operator(ChildParams, Kernel):
    """A node over child expressions (``terms``)."""

    def __init__(self, children=()):
        super().__init__()
        self._terms = nn.ModuleList(children)

    @property
    def terms(self):
        return tuple(self._terms)

    def bounds(self, xrange, n):
        los, his = zip(*(c.bounds(xrange, n) for c in self.terms))
        return {"children": tuple(los)}, {"children": tuple(his)}

    def x_rescale(self, params, shift, scale):
        return {"children": tuple(
            c.x_rescale(p, shift, scale)
            for c, p in zip(self.terms, params["children"]))}

    def __str__(self):
        return "(" + self._SEP.join(str(c) for c in self.terms) + ")"


@register_kernel
class Sum(Operator):
    """K = Σᵢ Kᵢ."""

    _SEP = " + "
    _COMMUTATIVE = True

    def gram(self, x1, x2):
        out = self.terms[0].gram(x1, x2)
        for c in self.terms[1:]:
            out = out + c.gram(x1, x2)
        return out

    def diag(self, x):
        out = self.terms[0].diag(x)
        for c in self.terms[1:]:
            out = out + c.diag(x)
        return out


@register_kernel
class Product(Operator):
    """K = ∏ᵢ Kᵢ elementwise."""

    _SEP = " * "
    _COMMUTATIVE = True

    def gram(self, x1, x2):
        out = self.terms[0].gram(x1, x2)
        for c in self.terms[1:]:
            out = out * c.gram(x1, x2)
        return out

    def diag(self, x):
        out = self.terms[0].diag(x)
        for c in self.terms[1:]:
            out = out * c.diag(x)
        return out


def _gate_before(x0: torch.Tensor, cp, gate: ChangePointGate) -> torch.Tensor:
    """Scalar gate g(x) ≈ 1 for x < cp, per point (x0 = the first input
    dimension): INDICATOR a hard ``x < cp``, SIGMOID 0.5·(1 + tanh((cp −
    x)/0.0025)), APPROX_INDICATOR a logistic of slope 100. All three share
    the JAX package's "before" orientation (its ``operators.py:111-113``
    says why it differs from gpbasics' APPROX_INDICATOR)."""
    if gate is ChangePointGate.INDICATOR:
        return (x0 < cp).to(x0.dtype)
    if gate is ChangePointGate.SIGMOID:
        return 0.5 * (1.0 + torch.tanh((cp - x0) / 0.0025))
    return 1.0 / (1.0 + torch.exp(100.0 * (x0 - cp)))


def changepoint_weights(x: torch.Tensor, locations: torch.Tensor,
                        gate: ChangePointGate) -> torch.Tensor:
    """Per-segment weights [..., n, k+1] for k sorted change points:
    w₀ = g(·, cp₀), wᵢ = (1 − g(·, cpᵢ₋₁))·g(·, cpᵢ), w_k = 1 − g(·, cp_{k−1}),
    as a running (1 − g) carry."""
    x0 = x[..., 0]
    ws = []
    prev = torch.ones_like(x0)
    for i in range(locations.shape[0]):
        g = _gate_before(x0, locations[i], gate)
        ws.append(prev * g)
        prev = prev * (1.0 - g)
    ws.append(prev)
    return torch.stack(ws, dim=-1)


@register_kernel
class ChangePoint(LocatedChildParams, Operator):
    """K = Σᵢ wᵢ(x)·Kᵢ(x, x')·wᵢ(x') over the first input dimension, with
    k = len(children) − 1 change points in ``locations`` (sorted at use).
    The children's order is the segments' order. ``trainable_locations``
    is carried in the AST as in the JAX package."""

    _AST_FIELDS = ("gate", "trainable_locations")
    _SEP = " ][ "

    def __init__(self, children=(), gate: ChangePointGate = DEFAULT_CONFIG.cp_gate,
                 trainable_locations: bool = True):
        super().__init__(children)
        self.gate = ChangePointGate(gate)
        self.trainable_locations = trainable_locations
        self.register_buffer("locations", None)

    def _weights(self, x):
        return changepoint_weights(x, torch.sort(self.locations).values,
                                   self.gate)

    def gram(self, x1, x2):
        w1, w2 = self._weights(x1), self._weights(x2)
        out = None
        for i, c in enumerate(self.terms):
            ki = c.gram(x1, x2) * (w1[..., :, None, i] * w2[..., None, :, i])
            out = ki if out is None else out + ki
        return out

    def diag(self, x):
        w = self._weights(x)
        out = None
        for i, c in enumerate(self.terms):
            di = c.diag(x) * w[..., i] ** 2
            out = di if out is None else out + di
        return out

    def bounds(self, xrange, n):
        """The children's bounds, and range ± 1.5·range for every
        location."""
        lo, hi = super().bounds(xrange, n)
        xr = _as_xrange(xrange)
        r = float(xr[0, 1] - xr[0, 0])
        k = len(self.terms) - 1
        lo["locations"] = np.full((k,), xr[0, 0] - 1.5 * r)
        hi["locations"] = np.full((k,), xr[0, 1] + 1.5 * r)
        return lo, hi

    def x_rescale(self, params, shift, scale):
        """The children's, and the locations mapped affinely (they are x
        positions on dimension 0)."""
        out = super().x_rescale(params, shift, scale)
        shift0 = torch.as_tensor(shift)
        scale0 = torch.as_tensor(scale)
        if shift0.ndim:
            shift0, scale0 = shift0[0], scale0[0]
        out["locations"] = params["locations"] * scale0 + shift0
        return out

    # --- tree surgery ------------------------------------------------------
    def _with_children(self, children) -> "ChangePoint":
        return ChangePoint(children, self.gate, self.trainable_locations)

    def with_kernel_appended(self, kernel: Kernel) -> "ChangePoint":
        """A ChangePoint with ``kernel`` after the last segment, sharing the
        other children; its locations are unset (the caller sets them)."""
        return self._with_children(self.terms + (kernel,))

    def with_kernel_prepended(self, kernel: Kernel) -> "ChangePoint":
        """As :meth:`with_kernel_appended`, before the first segment."""
        return self._with_children((kernel,) + self.terms)

    def prune(self, xrange) -> Kernel:
        """Drop degenerate change points of the installed locations: those
        outside the data range of x[:, 0] or within 1e-9 of the last kept
        one (in sorted order). Dropping change point i merges segments i
        and i + 1 into the earlier child. Returns a new ChangePoint sharing
        the kept children, its locations installed, or ``children[0]``
        when no change point survives."""
        xr = _as_xrange(xrange)
        locs = np.sort(self.locations.detach().cpu().numpy().reshape(-1))
        children, kept = [self.terms[0]], []
        prev = -np.inf
        for i, loc in enumerate(locs):
            if xr[0, 0] < loc < xr[0, 1] and (loc - prev) > 1e-9:
                prev = loc
                kept.append(loc)
                children.append(self.terms[i + 1])
        if not kept:
            return self.terms[0]
        out = self._with_children(children)
        out.locations = torch.as_tensor(
            np.asarray(kept), dtype=self.locations.dtype,
            device=self.locations.device)
        return out
