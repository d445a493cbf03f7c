"""The Partition operator and its partitioning models.

Counterpart of ``gaussianprocessfundamentals_tpu/kernels/partition.py``:
``PartitioningModel`` (``:31``), ``DistancePartitioning`` (``:48``),
``BoxPartitioning`` (``:74``), ``Partition`` (``:91``) and
``partitioning_to_dict`` / ``partitioning_from_dict`` (``:137-151``). A
partition assigns each point one id; the Gram is
Σ_p m_p(x1)·K_p(x1, x2)·m_p(x2)ᵀ with one-hot masks m_p, block diagonal
by construction. Models are frozen dataclasses, hashable and written to
the AST JSON as the JAX package writes them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from gaussianprocessfundamentals_tpu_torch.kernels.base import register_kernel
from gaussianprocessfundamentals_tpu_torch.kernels.operators import Operator


@dataclasses.dataclass(frozen=True)
class PartitioningModel:
    """A static rule that assigns each point one partition."""

    def num_partitions(self) -> int:
        raise NotImplementedError

    def assign(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., n, d] → int64 ids [..., n] in [0, num_partitions)."""
        raise NotImplementedError

    def masks(self, x: torch.Tensor) -> torch.Tensor:
        """One-hot [..., n, P] masks in x's dtype."""
        return torch.nn.functional.one_hot(
            self.assign(x), self.num_partitions()).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class DistancePartitioning(PartitioningModel):
    """Each point joins the nearest center (Euclidean, over the dimensions
    not in ``ignored_dims``); of equal distances the first center wins."""

    centers: Tuple[Tuple[float, ...], ...] = ()
    ignored_dims: Tuple[int, ...] = ()

    def num_partitions(self) -> int:
        return len(self.centers)

    def assign(self, x):
        c = torch.as_tensor(self.centers, dtype=x.dtype, device=x.device)
        if self.ignored_dims:
            keep = [i for i in range(c.shape[1]) if i not in self.ignored_dims]
            c, x = c[:, keep], x[..., keep]
        d2 = torch.sum((x[..., :, None, :] - c) ** 2, dim=-1)
        return torch.argmin(d2, dim=-1)


@dataclasses.dataclass(frozen=True)
class BoxPartitioning(PartitioningModel):
    """Partition p claims the points with edges[p−1] ≤ x[dim] < edges[p]:
    ``edges`` are the sorted interior edges, P = len(edges) + 1."""

    edges: Tuple[float, ...] = ()
    dim: int = 0

    def num_partitions(self) -> int:
        return len(self.edges) + 1

    def assign(self, x):
        e = torch.as_tensor(self.edges, dtype=x.dtype, device=x.device)
        return torch.searchsorted(e, x[..., self.dim].contiguous(), right=True)


@register_kernel
class Partition(Operator):
    """K = Σ_p m_p(x1)·K_p(x1, x2)·m_p(x2)ᵀ, one child per partition of
    ``model``; square and rectangular builds alike."""

    _AST_FIELDS = ("model",)

    def __init__(self, children=(), model: PartitioningModel = None):
        super().__init__(children)
        if model is None or len(self.terms) != model.num_partitions():
            raise ValueError("Partition needs a partitioning model and one "
                             "child kernel per partition")
        self.model = model

    def gram(self, x1, x2):
        m1, m2 = self.model.masks(x1), self.model.masks(x2)
        out = None
        for p, c in enumerate(self.terms):
            kp = c.gram(x1, x2) * (m1[..., :, None, p] * m2[..., None, :, p])
            out = kp if out is None else out + kp
        return out

    def diag(self, x):
        m = self.model.masks(x)
        out = None
        for p, c in enumerate(self.terms):
            dp = c.diag(x) * m[..., p]
            out = dp if out is None else out + dp
        return out

    def to_dict(self) -> dict:
        return {**super().to_dict(), "model": partitioning_to_dict(self.model)}

    def __str__(self):
        return "Part(" + ", ".join(str(c) for c in self.terms) + ")"


PARTITIONING_REGISTRY = {
    "DistancePartitioning": DistancePartitioning,
    "BoxPartitioning": BoxPartitioning,
}


def partitioning_to_dict(m: PartitioningModel) -> dict:
    d = {"type": type(m).__name__}
    for f in dataclasses.fields(m):
        d[f.name] = getattr(m, f.name)
    return d


def partitioning_from_dict(d: dict) -> PartitioningModel:
    """Inverse of :func:`partitioning_to_dict`, also after a JSON round trip
    (lists back to the hashable tuples)."""
    d = dict(d)
    cls = PARTITIONING_REGISTRY[d.pop("type")]
    for k, v in d.items():
        if isinstance(v, list):
            d[k] = tuple(tuple(e) if isinstance(e, list) else e for e in v)
    return cls(**d)
