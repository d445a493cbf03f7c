"""Mean functions of the PyTorch port.

Counterpart of ``gaussianprocessfundamentals_tpu/means/functions.py``:
``MeanFunction`` with ``+`` and ``*`` (``:54-80``), ``mean_from_dict``
(``:82``), ``ZeroMean``, ``ConstantMean``, ``LinearMean``,
``ExponentialMean`` and ``LogitMean`` (``:92-195``), and the operators
``MeanSum``, ``MeanProduct`` and ``MeanChangePoint`` (``:198-274``).
``mean(x)`` maps ``x: [..., n, d]`` to ``[..., n]``. Like kernels, means
are ``nn.Module``s holding their own parameters (an operator holds them in
its children); the JSON form, the params trees (``{"children": (p0, p1)}``
for an operator, plus ``"locations"`` for a change point), defaults and
positivity are the JAX package's. One difference: a ``MeanChangePoint``'s
gate is written to JSON as its value string and read back as the enum, as
kernels do; the JAX package writes the enum itself, which ``json`` cannot
serialise, and reads a string back without converting it.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from gaussianprocessfundamentals_tpu_torch.config import (
    DEFAULT_CONFIG,
    ChangePointGate,
)
from gaussianprocessfundamentals_tpu_torch.kernels.base import (
    ChildParams,
    HyperparameterModule,
    LocatedChildParams,
    _dt,
)
from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_map

MEAN_REGISTRY: Dict[str, type] = {}


def register_mean(cls):
    MEAN_REGISTRY[cls.__name__] = cls
    return cls


class MeanFunction(HyperparameterModule):
    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim
        for name in self.param_names():
            self.register_buffer(name, None)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x):
        return self.mean(x)

    def init_params(self, xrange=None, n: int = 0, generator=None, dtype=None):
        """Default (``generator=None``) or random initial parameters, as a
        params tree of tensors; :meth:`set_params` installs them."""
        raise NotImplementedError

    def positivity(self) -> dict:
        return {name: False for name in self.param_names()}

    def bounds(self, xrange=None, n: int = 0):
        """(lower, upper) trees shaped like the params: means are unbounded,
        and ``fit``'s bounds projection clips kernel hyperparameters only,
        as in the JAX package."""
        pos = self.positivity()
        return (tree_map(lambda _: -math.inf, pos),
                tree_map(lambda _: math.inf, pos))

    def __add__(self, other):
        return MeanSum(children=_merge_means(self, other, MeanSum))

    def __mul__(self, other):
        return MeanProduct(children=_merge_means(self, other, MeanProduct))

    def to_dict(self) -> dict:
        return {"type": type(self).__name__, "dim": self.dim}


def _merge_means(a, b, op_cls):
    """Flatten nested operators of one type, as the JAX package does."""
    out = []
    for m in (a, b):
        out.extend(m.terms if type(m) is op_cls else [m])
    return tuple(out)


def mean_from_dict(d: dict) -> MeanFunction:
    d = dict(d)
    name = d.pop("type")
    if name not in MEAN_REGISTRY:
        raise NotImplementedError(
            f"mean type {name!r} is not ported to the PyTorch package yet "
            f"(ported: {sorted(MEAN_REGISTRY)})"
        )
    if "children" in d:
        d["children"] = tuple(mean_from_dict(c) for c in d["children"])
    if isinstance(d.get("gate"), str):
        d["gate"] = ChangePointGate(d["gate"])
    return MEAN_REGISTRY[name](**d)


@register_mean
class ZeroMean(MeanFunction):
    """m(x) = 0. No params."""

    def mean(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def init_params(self, xrange=None, n=0, generator=None, dtype=None):
        return {}


@register_mean
class ConstantMean(MeanFunction):
    """m(x) = c; default c = 0.01, random init 0.01 + N(0, 1)."""

    def param_names(self):
        return ("c",)

    def mean(self, x):
        return self.c.expand(x.shape[:-1])

    def init_params(self, xrange=None, n=0, generator=None, dtype=None):
        v = torch.tensor(0.01, dtype=torch.float64)
        if generator is not None:
            v = v + torch.randn((), generator=generator, dtype=torch.float64)
        return {"c": v.to(_dt(dtype))}


@register_mean
class LinearMean(MeanFunction):
    """m(x) = Σ_d slope_d·x_d; default slope = 1/d, random init
    slope·(1 + N(0, 1))."""

    def param_names(self):
        return ("slope",)

    def mean(self, x):
        return torch.sum(x * self.slope, dim=-1)

    def init_params(self, xrange=None, n=0, generator=None, dtype=None):
        v = torch.full((self.dim,), 1.0 / self.dim, dtype=torch.float64)
        if generator is not None:
            v = v * (1.0 + torch.randn((self.dim,), generator=generator,
                                       dtype=torch.float64))
        return {"slope": v.to(_dt(dtype))}


@register_mean
class ExponentialMean(MeanFunction):
    """m(x) = base^(Σ_d (scale_d·x_d − shift_d)); defaults scale = 1,
    shift = 0, base = e; random init scale + 0.1·N(0, 1)."""

    def param_names(self):
        return ("scale", "shift", "base")

    def mean(self, x):
        expo = torch.sum(x * self.scale - self.shift, dim=-1)
        return torch.pow(self.base, expo)

    def init_params(self, xrange=None, n=0, generator=None, dtype=None):
        scale = torch.ones((self.dim,), dtype=torch.float64)
        if generator is not None:
            scale = scale + 0.1 * torch.randn((self.dim,), generator=generator,
                                              dtype=torch.float64)
        return {"scale": scale.to(_dt(dtype)),
                "shift": torch.zeros((self.dim,), dtype=_dt(dtype)),
                "base": torch.tensor(math.e, dtype=_dt(dtype))}

    def positivity(self):
        return {"scale": False, "shift": False, "base": True}


@register_mean
class LogitMean(MeanFunction):
    """m(x) = max / (1 + exp(Σ_d (steep_d·x_d − shift_d))); defaults
    steepness = −1, shift = 0, max = 1."""

    def param_names(self):
        return ("steepness", "shift", "max_value")

    def mean(self, x):
        z = torch.sum(x * self.steepness - self.shift, dim=-1)
        return self.max_value / (1.0 + torch.exp(z))

    def init_params(self, xrange=None, n=0, generator=None, dtype=None):
        return {"steepness": torch.full((self.dim,), -1.0, dtype=_dt(dtype)),
                "shift": torch.zeros((self.dim,), dtype=_dt(dtype)),
                "max_value": torch.tensor(1.0, dtype=_dt(dtype))}

    def positivity(self):
        return {"steepness": False, "shift": False, "max_value": True}


class MeanOperator(ChildParams, MeanFunction):
    """A mean over child means (``terms``, the JAX package's ``children``:
    that name is nn.Module's own iterator over submodules); its params tree
    is ``{"children": (p0, p1, ...)}`` and each child module holds its
    own."""

    def __init__(self, children=(), dim: int = 1):
        super().__init__(dim)
        self.terms = nn.ModuleList(children)

    def to_dict(self):
        return {"type": type(self).__name__, "dim": self.dim,
                "children": [c.to_dict() for c in self.terms]}


@register_mean
class MeanSum(MeanOperator):
    """m = Σᵢ mᵢ."""

    def mean(self, x):
        out = self.terms[0].mean(x)
        for c in self.terms[1:]:
            out = out + c.mean(x)
        return out


@register_mean
class MeanProduct(MeanOperator):
    """m = ∏ᵢ mᵢ."""

    def mean(self, x):
        out = self.terms[0].mean(x)
        for c in self.terms[1:]:
            out = out * c.mean(x)
        return out


@register_mean
class MeanChangePoint(LocatedChildParams, MeanOperator):
    """m = Σᵢ wᵢ(x)·mᵢ(x), the change-point weights of
    :func:`..kernels.operators.changepoint_weights` over the sorted
    ``locations``."""

    def __init__(self, children=(), dim: int = 1,
                 gate: ChangePointGate = DEFAULT_CONFIG.cp_gate):
        super().__init__(children, dim)
        self.gate = ChangePointGate(gate)
        self.register_buffer("locations", None)

    def mean(self, x):
        from gaussianprocessfundamentals_tpu_torch.kernels.operators import (
            changepoint_weights,
        )

        w = changepoint_weights(x, torch.sort(self.locations).values,
                                self.gate)
        out = None
        for i, c in enumerate(self.terms):
            mi = c.mean(x) * w[..., i]
            out = mi if out is None else out + mi
        return out

    def to_dict(self):
        return {**super().to_dict(), "gate": self.gate.value}
