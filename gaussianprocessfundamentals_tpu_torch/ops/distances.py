"""Pairwise distances for the Gram builders.

Counterpart of ``gaussianprocessfundamentals_tpu/ops/distances.py:19-54``.
``a: [..., n, d]``, ``b: [..., m, d]`` → ``[..., n, m]``.
"""
from __future__ import annotations

import torch


def sq_euclidean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances.

    d = 1 uses the direct difference, which is exact; d > 1 uses the
    |a|² − 2ab + |b|² expansion (one matmul instead of an [n, m, d]
    broadcast), clamped at zero against rounding.
    """
    if a.shape[-1] == 1:
        diff = a - b.transpose(-1, -2)
        return diff * diff
    aa = torch.sum(a * a, dim=-1, keepdim=True)
    bb = torch.sum(b * b, dim=-1, keepdim=True)
    ab = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp_min(aa - 2.0 * ab + bb.transpose(-1, -2), 0.0)


def euclidean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distances with a gradient-safe square root: where d² is 0
    (the diagonal) the root takes 1 and the result is replaced by 0, so
    the gradient there is 0 and not inf; values elsewhere are √d²."""
    d2 = sq_euclidean(a, b)
    pos = d2 > 0.0
    safe = torch.sqrt(torch.where(pos, d2, torch.ones_like(d2)))
    return torch.where(pos, safe, torch.zeros_like(d2))


def manhattan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L1 distances by broadcasting: O(n·m·d) memory, fine at GP's small d."""
    if a.shape[-1] == 1:
        return torch.abs(a - b.transpose(-1, -2))
    return torch.sum(torch.abs(a[..., :, None, :] - b[..., None, :, :]), dim=-1)


def sq_manhattan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L1 distances."""
    d = manhattan(a, b)
    return d * d
