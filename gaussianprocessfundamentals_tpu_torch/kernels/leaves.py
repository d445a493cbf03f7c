"""Leaf kernels of the PyTorch port.

Counterpart of ``gaussianprocessfundamentals_tpu/kernels/leaves.py``: the
``LeafKernel`` scaffolding (``:33``), ``SquaredExponentialKernel``
(``:236``, with ARD lengthscales), ``Matern32Kernel`` (``:339``) and
``Matern52Kernel`` (``:363``) in the Manhattan-distance form of ``_matern``
(``:318``). Formulas, defaults and bounds are the JAX package's.
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
        d = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
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
        p = {name: True for name in self._OWN_PARAMS}
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

    # x-unit semantics per param name: "length" multiplies by the x scale;
    # anything else is unit-free
    _X_UNITS = {"lengthscale": "length"}

    def x_rescale(self, params, shift, scale):
        scale = torch.as_tensor(scale)
        s_iso = torch.mean(scale)
        out = {}
        for name, v in params.items():
            if self._X_UNITS.get(name) == "length":
                out[name] = v * (s_iso if v.ndim == 0 else scale)
            else:
                out[name] = v
        return out


class _LengthscaleKernel(LeafKernel):
    """A leaf whose only own parameter is ``lengthscale``: default
    range/10, bounds [5·range/n, range/3]."""

    _OWN_PARAMS = ("lengthscale",)

    def _own_defaults(self, xr, n):
        r = float(xr[0, 1] - xr[0, 0])
        return {"lengthscale": r / 10.0 if r > 0 else 1.0}

    def _own_bounds(self, xr, n):
        r = float(xr[0, 1] - xr[0, 0])
        return {"lengthscale": 5.0 * r / max(n, 1)}, {"lengthscale": r / 3.0}


@register_kernel
class SquaredExponentialKernel(_LengthscaleKernel):
    """k = exp(−½ d²(x,x') / ℓ²), d = Euclidean; ARD when ℓ is a vector."""

    def _gram(self, x1, x2):
        ls = self.lengthscale
        if ls.ndim > 0:
            return torch.exp(-0.5 * dist.sq_euclidean(x1 / ls, x2 / ls))
        return torch.exp(-0.5 * dist.sq_euclidean(x1, x2) / (ls * ls))


RBFKernel = SquaredExponentialKernel


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
