"""Auxiliary utilities: flat hyperparameter (de)serialisation, unique rows
and distance-to-similarity maps.

Counterpart of ``gaussianprocessfundamentals_tpu/utils/auxiliary.py``: the
flat vector is in ``ravel_pytree``'s order (:func:`..utils.tree.ravel_tree`),
so a vector written by either package reads back in the other, and every
parameter round-trips (the reference's deserialiser sliced every parameter
from offset 0).
"""
from __future__ import annotations

import enum
from typing import Any, Callable, Tuple

import torch

from gaussianprocessfundamentals_tpu_torch.utils.tree import ravel_tree


def serialize_params(params: Any) -> Tuple[torch.Tensor, Callable]:
    """A hyperparameter tree as a 1-D vector; returns (vector, unravel)."""
    return ravel_tree(params)


def deserialize_params(vector: torch.Tensor, template: Any) -> Any:
    """The tree shaped like ``template`` holding ``vector``'s values."""
    _, unravel = ravel_tree(template)
    return unravel(torch.as_tensor(vector))


def unique_rows(x: torch.Tensor) -> torch.Tensor:
    """The unique rows of a 2-D tensor, sorted lexicographically."""
    return torch.unique(x, dim=0)


class SimilarityTransform(enum.Enum):
    """Distance → similarity maps for partitioning criteria."""

    LINEAR = "linear"
    SQRT = "sqrt"
    LOG = "log"
    RECIPROCAL = "reciprocal"


def similarity_from_distance(
    d: torch.Tensor, kind: SimilarityTransform = SimilarityTransform.LINEAR
) -> torch.Tensor:
    if kind is SimilarityTransform.LINEAR:
        return -d
    if kind is SimilarityTransform.SQRT:
        return -torch.sqrt(torch.clamp_min(d, 0.0))
    if kind is SimilarityTransform.LOG:
        return -torch.log1p(torch.clamp_min(d, 0.0))
    return 1.0 / (1.0 + torch.clamp_min(d, 0.0))
