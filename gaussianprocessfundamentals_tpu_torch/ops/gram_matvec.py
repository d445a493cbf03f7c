"""Materialisation-free Gram products in plain PyTorch, and the routers
that pick a kernel for them.

Counterpart of ``gram_matvec`` (``:36``), ``gram_matvec_cross``
(``:98``), ``streamed_gram_matvec`` (``:78``),
``streamed_gram_matvec_cross`` (``:123``),
``streamed_gram_matvec_symmetric`` (``:143``), ``gram_diag_sum``
(``:200``), ``lowrank_gram_vjp`` (``:205``) and ``lowrank_gram_vjp_cross``
(``:233``) of ``gaussianprocessfundamentals_tpu/ops/gram_matvec.py``:
K(x1, x2)·V and the gradient of Σ(UWᵀ)∘K(x1, x2) built in [block, n2]
row panels, each used and dropped, so memory is O(block·n2) and K never
exists whole. This is the CPU path of the port and the plain version the
CUDA kernels of :mod:`.cuda_gram` (K1) and :mod:`.cuda_lrvjp` (K2) are
held against.

The routers :func:`gram_matvec` and :func:`gram_matvec_cross` hand a
product to the version :func:`.cuda_gram.fused_matvec_cross_for` picks for
the device: K1 for SE and Matérn leaves, K3 for the composite expressions
its generated code covers, this module's streamed version for every other
covariance and on the CPU. They keep the JAX package's names for its
callers; the port's own paths (the iterative core, the mesh products) hold
the closure :func:`.cuda_gram.fused_matvec_cross_for` returns, which
resolves the route once per operator. The JAX package's
``GPF_FORCE_FUSED`` and ``GPF_SYM`` switches are not ported: on a card the
kernel is the product, and the symmetric tile product is there only for
callers that ask for it by name.
"""
from __future__ import annotations

import torch

from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_unflatten,
)


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


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    pad = rows - a.shape[0]
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))]) if pad else a


def streamed_gram_matvec_symmetric(
    kernel, x: torch.Tensor, V: torch.Tensor, block: int = 4096
) -> torch.Tensor:
    """K(x, x) @ V from the upper triangle of the [block, block] tile grid:
    each tile K_ij (i ≤ j) is built once, and an off-diagonal one serves
    both out_i += K_ij·V_j and out_j += K_ijᵀ·V_i, so nb(nb + 1)/2 of the
    nb² tiles are evaluated. x and V are zero-padded to whole tiles: the
    padded rows of V are zero, so they add nothing to the real rows, and
    the padded output rows are dropped. V: [n, r] or [n]. Opt-in: no route
    of the port sends a product here."""
    n = x.shape[0]
    if n == 0:
        return V.new_zeros(V.shape)
    blk = min(block, n)
    nb = -(-n // blk)
    xp = _pad_rows(x, nb * blk)
    Vp = _pad_rows(V, nb * blk)
    xs = [xp[i * blk:(i + 1) * blk] for i in range(nb)]
    vs = [Vp[i * blk:(i + 1) * blk] for i in range(nb)]
    acc = [torch.zeros_like(v) for v in vs]
    for i in range(nb):
        for j in range(i, nb):
            K = kernel.gram(xs[i], xs[j])
            acc[i] = acc[i] + K @ vs[j]
            if j != i:
                acc[j] = acc[j] + K.T @ vs[i]
    return torch.cat(acc)[:n]


def gram_diag_sum(kernel, x: torch.Tensor) -> torch.Tensor:
    """tr K(x, x) without the matrix."""
    return torch.sum(kernel.diag(x))


def gram_matvec_cross(kernel, x1: torch.Tensor, x2: torch.Tensor,
                      V: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """K(x1, x2) @ V through the version the device takes (K1, K3, or the
    streamed plain version in [block, n2] panels); the unit of work of the
    mesh-sharded matvec."""
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
        fused_matvec_cross_for,
    )

    return fused_matvec_cross_for(kernel, x1, x2, block)(V)


def gram_matvec(kernel, x: torch.Tensor, V: torch.Tensor, block: int = 2048
                ) -> torch.Tensor:
    """K(x, x) @ V: square form of :func:`gram_matvec_cross`."""
    return gram_matvec_cross(kernel, x, x, V, block)


def grads_or_zeros(out: torch.Tensor, leaves, grad_outputs=None):
    """``torch.autograd.grad`` of ``out`` with respect to ``leaves``, with
    zeros for leaves ``out`` does not depend on (an unscaled kernel's
    diagonal depends on nothing)."""
    if not out.requires_grad:
        return [torch.zeros_like(p) for p in leaves]
    gs = torch.autograd.grad(out, leaves, grad_outputs, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for g, p in zip(gs, leaves)]


def lowrank_gram_vjp_cross(
    kernel, x1: torch.Tensor, x2: torch.Tensor, U: torch.Tensor,
    W: torch.Tensor, block: int = 2048,
) -> dict:
    """∂/∂θ of Σᵢⱼ (U Wᵀ)ᵢⱼ K(x1, x2)ᵢⱼ(θ) for the kernel's installed
    hyperparameters θ, as a params tree; U: [n1, r], W: [n2, r].

    Each [block, n2] panel of K and of the cotangent is built, its scalar
    contraction differentiated by autograd, and both dropped: memory is
    O(block·n2), and no panel is kept for a later backward pass.
    """
    with torch.enable_grad(), kernel.differentiable() as params:
        leaves = tree_leaves(params)
        grads = [torch.zeros_like(p) for p in leaves]
        Wt = W.detach().T
        for s in range(0, x1.shape[0], block):
            Kb = kernel.gram(x1[s:s + block], x2)
            cot_b = U[s:s + block].detach() @ Wt
            gs = grads_or_zeros(torch.sum(Kb * cot_b), leaves)
            grads = [a + b for a, b in zip(grads, gs)]
    return tree_unflatten(params, grads)


def lowrank_gram_vjp(kernel, x: torch.Tensor, U: torch.Tensor,
                     W: torch.Tensor, block: int = 2048) -> dict:
    """Square (x1 = x2 = x) form of :func:`lowrank_gram_vjp_cross`."""
    return lowrank_gram_vjp_cross(kernel, x, x, U, W, block)
