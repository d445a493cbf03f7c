"""Leaf kernels of the PyTorch port.

Counterpart of ``gaussianprocessfundamentals_tpu/kernels/leaves.py``: the
``LeafKernel`` scaffolding (``:33``), ``ConstantKernel`` (``:140``),
``WhiteNoiseKernel`` (``:164``), ``LinearKernel`` (``:199``),
``SquaredExponentialKernel`` (``:236``, with ARD lengthscales),
``PeriodicKernel`` (``:273``), ``Matern32Kernel`` (``:339``) and
``Matern52Kernel`` (``:363``) in the Manhattan-distance form of ``_matern``
(``:318``), and ``RationalQuadraticKernel`` (``:387``). Formulas, defaults,
bounds, positivity and x units are the JAX package's.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from gaussianprocessfundamentals_tpu_torch.kernels.base import (
    Kernel,
    _as_xrange,
    _dt,
    register_kernel,
)
from gaussianprocessfundamentals_tpu_torch.ops import distances as dist


class LeafKernel(Kernel):
    """Common scaffolding: optional output-scale ``variance``, bounds-based
    random init."""

    _AST_FIELDS = ("dim", "scaled")
    _OWN_PARAMS: Tuple[str, ...] = ()
    # own params that may take any sign (the rest are optimised in log space)
    _SIGNED: Tuple[str, ...] = ()

    def __init__(self, dim: int = 1, scaled: bool = False):
        super().__init__()
        self.dim = dim
        self.scaled = scaled
        for name in self.param_names():
            self.register_buffer(name, None)

    def param_names(self):
        return self._OWN_PARAMS + (("variance",) if self.scaled else ())

    # subclasses implement these
    def _gram(self, x1, x2):
        raise NotImplementedError

    def _diag(self, x):
        return torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)

    def _own_defaults(self, xr: np.ndarray, n: int) -> dict:
        raise NotImplementedError

    def _own_bounds(self, xr: np.ndarray, n: int):
        raise NotImplementedError

    # shared machinery ----------------------------------------------------
    def gram(self, x1, x2):
        k = self._gram(x1, x2)
        if self.scaled:
            k = self.variance * k
        return k

    def diag(self, x):
        d = self._diag(x)
        if self.scaled:
            d = self.variance * d
        return d

    def init_params(self, xrange, n, generator=None, dtype=None):
        dtype = _dt(dtype)
        xr = _as_xrange(xrange)
        p = self._own_defaults(xr, n)
        if self.scaled:
            # reference default output scale 0.1
            p["variance"] = 0.1
        if generator is not None:
            lo, hi = self.bounds(xrange, n)
            out = {}
            for name, v in sorted(p.items()):
                v = np.asarray(v, np.float64)
                l = np.where(np.isfinite(lo[name]), lo[name], v - np.abs(v) - 1.0)
                h = np.where(np.isfinite(hi[name]), hi[name], v + np.abs(v) + 1.0)
                u = torch.rand(v.shape, generator=generator, dtype=torch.float64)
                out[name] = torch.as_tensor(l) + u * torch.as_tensor(h - l)
            p = out
        return {k: torch.as_tensor(v, dtype=dtype) for k, v in p.items()}

    def positivity(self):
        p = {name: name not in self._SIGNED for name in self._OWN_PARAMS}
        if self.scaled:
            p["variance"] = True
        return p

    def bounds(self, xrange, n):
        xr = _as_xrange(xrange)
        lo, hi = self._own_bounds(xr, n)
        if self.scaled:
            lo["variance"] = 1e-6
            hi["variance"] = np.inf
        return lo, hi

    # x-unit semantics per param name: "length" multiplies by the x scale,
    # "position" maps affinely (·scale + shift); anything else is unit-free
    _X_UNITS = {"lengthscale": "length", "period": "length",
                "offset": "position"}

    def x_rescale(self, params, shift, scale):
        shift = torch.as_tensor(shift)
        scale = torch.as_tensor(scale)
        # isotropic (scalar) length params on multi-d inputs take the mean
        # scale, exact when the per-dim scales agree
        s_iso = torch.mean(scale)
        out = {}
        for name, v in params.items():
            unit = self._X_UNITS.get(name)
            if unit == "length":
                out[name] = v * (s_iso if v.ndim == 0 else scale)
            elif unit == "position":
                out[name] = v * scale + shift
            else:
                out[name] = v
        return out

    @staticmethod
    def _lengthscale_bounds(xr: np.ndarray, n: int):
        """Shared SE/PER/Matérn/RQ lengthscale bounds [5·range/n, range/3]."""
        r = float(xr[0, 1] - xr[0, 0])
        return 5.0 * r / max(n, 1), r / 3.0


@register_kernel
class ConstantKernel(LeafKernel):
    """k(x, x') = c."""

    _OWN_PARAMS = ("c",)

    def _gram(self, x1, x2):
        shape = torch.broadcast_shapes(x1.shape[:-2], x2.shape[:-2]) + (
            x1.shape[-2], x2.shape[-2])
        return self.c * torch.ones(shape, dtype=x1.dtype, device=x1.device)

    def _diag(self, x):
        return self.c * torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)

    def _own_defaults(self, xr, n):
        return {"c": 1.0}

    def _own_bounds(self, xr, n):
        return {"c": 1e-8}, {"c": np.inf}


@register_kernel
class WhiteNoiseKernel(LeafKernel):
    """Identity on coincident points: EXACT per-dimension row equality, never
    a distance test (a rounded d² ≤ 0 test misses coincident pairs), so a
    rectangular train × test block is zero unless a test point equals a
    train point. No own hyperparameters (``scaled=True`` adds a variance)."""

    def _gram(self, x1, x2):
        eq = torch.all(x1[..., :, None, :] == x2[..., None, :, :], dim=-1)
        return eq.to(x1.dtype)

    def _own_defaults(self, xr, n):
        return {}

    def _own_bounds(self, xr, n):
        return {}, {}


@register_kernel
class LinearKernel(LeafKernel):
    """k(x, x') = (x − c)·(x' − c)ᵀ with a per-dimension, unbounded offset
    c in x units (default: the middle of the range)."""

    _OWN_PARAMS = ("offset",)
    _SIGNED = ("offset",)

    def _gram(self, x1, x2):
        return torch.matmul(x1 - self.offset,
                            (x2 - self.offset).transpose(-1, -2))

    def _diag(self, x):
        a = x - self.offset
        return torch.sum(a * a, dim=-1)

    def _own_defaults(self, xr, n):
        return {"offset": (xr[:, 0] + xr[:, 1]) / 2.0}

    def _own_bounds(self, xr, n):
        d = xr.shape[0]
        return ({"offset": np.full((d,), -np.inf)},
                {"offset": np.full((d,), np.inf)})


class _LengthscaleKernel(LeafKernel):
    """A leaf whose only own parameter is ``lengthscale``: default
    range/10, bounds [5·range/n, range/3]."""

    _OWN_PARAMS = ("lengthscale",)

    def _own_defaults(self, xr, n):
        r = float(xr[0, 1] - xr[0, 0])
        return {"lengthscale": r / 10.0 if r > 0 else 1.0}

    def _own_bounds(self, xr, n):
        lo, hi = self._lengthscale_bounds(xr, n)
        return {"lengthscale": lo}, {"lengthscale": hi}


@register_kernel
class SquaredExponentialKernel(_LengthscaleKernel):
    """k = exp(−½ d²(x,x') / ℓ²), d = Euclidean; ARD when ℓ is a vector."""

    def _gram(self, x1, x2):
        ls = self.lengthscale
        if ls.ndim > 0:
            return torch.exp(-0.5 * dist.sq_euclidean(x1 / ls, x2 / ls))
        return torch.exp(-0.5 * dist.sq_euclidean(x1, x2) / (ls * ls))


RBFKernel = SquaredExponentialKernel


@register_kernel
class PeriodicKernel(LeafKernel):
    """k = exp(−2 sin²(π·d/p) / ℓ²), d = Manhattan; params ordered [ℓ, p].

    ℓ divides the dimensionless sin² term, so it carries no x units; only
    the period rescales with x."""

    _OWN_PARAMS = ("lengthscale", "period")
    _X_UNITS = {"period": "length"}

    def _gram(self, x1, x2):
        s = torch.sin(math.pi * dist.manhattan(x1, x2) / self.period)
        ls = self.lengthscale
        return torch.exp(-2.0 * s * s / (ls * ls))

    def _own_defaults(self, xr, n):
        r = float(xr[0, 1] - xr[0, 0])
        r = r if r > 0 else 1.0
        return {"lengthscale": r / 10.0, "period": r / 10.0}

    def _own_bounds(self, xr, n):
        llo, lhi = self._lengthscale_bounds(xr, n)
        r = float(xr[0, 1] - xr[0, 0])
        # period bounds [10·range/n, range/5]
        return ({"lengthscale": llo, "period": 10.0 * r / max(n, 1)},
                {"lengthscale": lhi, "period": r / 5.0})


def _matern(ls, x1, x2, frac_const: float):
    ls = torch.abs(ls)
    if ls.ndim > 0:
        dd = dist.manhattan(x1 / ls, x2 / ls)
    else:
        dd = dist.manhattan(x1, x2) / ls
    frac = frac_const * dd
    poly = 1.0 + frac
    if frac_const == math.sqrt(5.0):
        poly = poly + 5.0 * dd * dd / 3.0
    return poly * torch.exp(-frac)


@register_kernel
class Matern32Kernel(_LengthscaleKernel):
    """k = (1 + √3 d/ℓ)·exp(−√3 d/ℓ), d = Manhattan."""

    def _gram(self, x1, x2):
        return _matern(self.lengthscale, x1, x2, math.sqrt(3.0))


@register_kernel
class Matern52Kernel(_LengthscaleKernel):
    """k = (1 + √5 d/ℓ + 5d²/3ℓ²)·exp(−√5 d/ℓ), d = Manhattan."""

    def _gram(self, x1, x2):
        return _matern(self.lengthscale, x1, x2, math.sqrt(5.0))


@register_kernel
class RationalQuadraticKernel(LeafKernel):
    """k = (1 + d²/(2αℓ²))^(−α), d = Euclidean; ARD when ℓ is a vector."""

    _OWN_PARAMS = ("lengthscale", "alpha")

    def _gram(self, x1, x2):
        ls, al = self.lengthscale, self.alpha
        if ls.ndim > 0:
            d2 = dist.sq_euclidean(x1 / ls, x2 / ls)
            return torch.pow(1.0 + d2 / (2.0 * al), -al)
        d2 = dist.sq_euclidean(x1, x2)
        return torch.pow(1.0 + d2 / (2.0 * al * ls * ls), -al)

    def _own_defaults(self, xr, n):
        r = float(xr[0, 1] - xr[0, 0])
        return {"lengthscale": r / 10.0 if r > 0 else 1.0, "alpha": 1.0}

    def _own_bounds(self, xr, n):
        lo, hi = self._lengthscale_bounds(xr, n)
        return ({"lengthscale": lo, "alpha": 1e-3},
                {"lengthscale": hi, "alpha": np.inf})
