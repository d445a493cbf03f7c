"""Materialisation-free Gram products in plain PyTorch.

Counterpart of ``streamed_gram_matvec`` (``:78``) and
``streamed_gram_matvec_cross`` (``:123``) of
``gaussianprocessfundamentals_tpu/ops/gram_matvec.py``: K(x1, x2)·V built in
[block, n2] row panels, each used and dropped, so memory is O(block·n2) and
K never exists whole. This is the CPU path of the port and the plain version
the CUDA kernel of :mod:`.cuda_gram` is held against.
"""
from __future__ import annotations

import torch


def streamed_gram_matvec_cross(
    kernel, x1: torch.Tensor, x2: torch.Tensor, V: torch.Tensor,
    block: int = 2048,
) -> torch.Tensor:
    """K(x1, x2) @ V; x1: [n1, d], x2: [n2, d], V: [n2, r] or [n2]."""
    n1 = x1.shape[0]
    if n1 == 0:
        return V.new_zeros((0,) + tuple(V.shape[1:]))
    return torch.cat([
        torch.matmul(kernel.gram(x1[s:s + block], x2), V)
        for s in range(0, n1, block)
    ])


def streamed_gram_matvec(
    kernel, x: torch.Tensor, V: torch.Tensor, block: int = 2048
) -> torch.Tensor:
    """K(x, x) @ V in row panels."""
    return streamed_gram_matvec_cross(kernel, x, x, V, block)
