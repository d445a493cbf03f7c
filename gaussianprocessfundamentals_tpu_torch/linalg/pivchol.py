"""Partial (rank-k) pivoted Cholesky of a kernel Gram matrix, matrix-free.

Counterpart of ``gaussianprocessfundamentals_tpu/linalg/pivchol.py:28``:
the preconditioner factor of the iterative posterior, P = σ²I + LLᵀ. Each
step builds one kernel column from x (O(n·d) memory, never K).

The loop runs in Python with no host synchronisation per step: the pivot
stays a device index tensor, read and written with ``index_select`` and
``index_fill``.
"""
from __future__ import annotations

import torch


def partial_pivoted_cholesky(kernel, x: torch.Tensor, k: int) -> torch.Tensor:
    """Rank-``k`` pivoted Cholesky factor L [n, k] with LLᵀ ≈ K(x, x).

    Greedy on the largest remaining diagonal (Harbrecht et al. 2012). A
    pivot that has decayed below the relative floor freezes its column at
    zero instead of dividing by round-off, so LLᵀ stops at the achieved
    numerical rank.
    """
    n = x.shape[0]
    diag = kernel.diag(x).clone()
    # relative pivot floor: past ~100·eps of the largest initial pivot the
    # residual diagonal is round-off, and dividing by its square root blows
    # the factor up
    floor = 100.0 * torch.finfo(x.dtype).eps * torch.max(diag)
    L = torch.zeros((n, k), dtype=x.dtype, device=x.device)
    for i in range(k):
        p = torch.argmax(diag).reshape(1)
        col = kernel.gram(x, x.index_select(0, p))[:, 0]
        col = col - torch.mv(L, L.index_select(0, p)[0])
        piv = diag.index_select(0, p)[0]
        ok = piv > floor
        sq = torch.sqrt(torch.where(ok, piv, torch.ones_like(piv)))
        l_i = col * torch.where(ok, 1.0 / sq, torch.zeros_like(sq))
        # the pivot row's entry is exactly √piv: set it to stop drift
        l_i.index_copy_(0, p, torch.where(ok, sq, torch.zeros_like(sq)).reshape(1))
        L[:, i] = l_i
        diag = torch.clamp_min(diag - l_i * l_i, 0.0)
        diag.index_fill_(0, p, 0.0)
    return L
