"""Mean functions of the PyTorch port.

Counterpart of ``gaussianprocessfundamentals_tpu/means/functions.py``:
``MeanFunction`` with ``+`` (``:54``), ``mean_from_dict`` (``:82``),
``ZeroMean`` (``:92``), ``ConstantMean`` (``:112``), ``LinearMean``
(``:131``) and the ``MeanSum`` operator (``:199-227``). ``mean(x)`` maps
``x: [..., n, d]`` to ``[..., n]``. Like kernels, means are ``nn.Module``s
holding their own parameters (a ``MeanSum`` holds them in its children);
the JSON form, the params trees (``{"children": (p0, p1)}`` for a sum),
defaults and positivity are the JAX package's.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from gaussianprocessfundamentals_tpu_torch.kernels.base import (
    ChildParams,
    HyperparameterModule,
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
        return MeanSum(children=_merge_sum(self, other))

    def to_dict(self) -> dict:
        return {"type": type(self).__name__, "dim": self.dim}


def _merge_sum(a, b):
    """Flatten nested sums, as the JAX package does."""
    out = []
    for m in (a, b):
        out.extend(m.terms if type(m) is MeanSum else [m])
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
class MeanSum(ChildParams, MeanFunction):
    """m = Σᵢ mᵢ; its params tree is ``{"children": (p0, p1, ...)}`` and
    each child module holds its own."""

    def __init__(self, children=(), dim: int = 1):
        super().__init__(dim)
        # ``terms``, not the JAX package's ``children``: that name is
        # nn.Module's own iterator over submodules
        self.terms = nn.ModuleList(children)

    def mean(self, x):
        out = self.terms[0].mean(x)
        for c in self.terms[1:]:
            out = out + c.mean(x)
        return out

    def to_dict(self):
        return {"type": "MeanSum", "dim": self.dim,
                "children": [c.to_dict() for c in self.terms]}
