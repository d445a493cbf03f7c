"""Mean functions of the PyTorch port.

Counterpart of ``gaussianprocessfundamentals_tpu/means/functions.py``:
``MeanFunction``, ``ZeroMean`` (``:92``) and ``mean_from_dict`` (``:82``).
``mean(x)`` maps ``x: [..., n, d]`` to ``[..., n]``. Like kernels, means are
``nn.Module``s holding their own parameters; the JSON form is the JAX
package's.
"""
from __future__ import annotations

from typing import Dict

import torch

from gaussianprocessfundamentals_tpu_torch.kernels.base import (
    HyperparameterModule,
)

MEAN_REGISTRY: Dict[str, type] = {}


def register_mean(cls):
    MEAN_REGISTRY[cls.__name__] = cls
    return cls


class MeanFunction(HyperparameterModule):
    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x):
        return self.mean(x)

    def init_params(self, xrange=None, n: int = 0, generator=None, dtype=None):
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"type": type(self).__name__, "dim": self.dim}


def mean_from_dict(d: dict) -> MeanFunction:
    d = dict(d)
    name = d.pop("type")
    if name not in MEAN_REGISTRY:
        raise NotImplementedError(
            f"mean type {name!r} is not ported to the PyTorch package yet "
            f"(ported: {sorted(MEAN_REGISTRY)})"
        )
    return MEAN_REGISTRY[name](**d)


@register_mean
class ZeroMean(MeanFunction):
    """m(x) = 0. No params."""

    def mean(self, x):
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def init_params(self, xrange=None, n=0, generator=None, dtype=None):
        return {}
