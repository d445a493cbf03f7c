"""Mesh-sharded Gram·V and low-rank-cotangent gradient.

Counterpart of ``gaussianprocessfundamentals_tpu/parallel/mesh_matvec.py``
(``mesh_gram_matvec`` ``:56``, ``mesh_lowrank_vjp`` ``:103``): the GP
analogue of sequence parallelism. Each rank owns a row panel of x (its
:func:`.meshes.row_range`) and contracts K(x_loc, x) against the whole
right-hand side through the kernels of one card: K1 for SE and Matérn
leaves, K3 for composite expressions, the streamed plain version for the
rest (:func:`..ops.cuda_gram.fused_matvec_cross_for`, the closure form of
the router :func:`..ops.gram_matvec.gram_matvec_cross`, resolved once per
operator and not per product). No K panel is held:
per-rank memory is O(n·(d + r)), not the O(n²/P) of resident panels.

Communication: one all-gather of the [n, r] product per matvec, and one
all-reduce of the handful of gradient scalars per VJP. x ([n, d], d small)
is replicated on every rank. A panel's padding rows (n not a multiple of
P) are not computed: the rank's product is zero-padded to the common panel
height before the gather and the padding is sliced off after it, so
results are exact, as the JAX package's padded rows are.
"""
from __future__ import annotations

import torch

from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
    fused_matvec_cross_for,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_lrvjp import (
    fused_lowrank_vjp_cross_for,
)
from gaussianprocessfundamentals_tpu_torch.parallel.meshes import (
    Mesh,
    all_gather_rows,
    all_reduce_tree,
    pad_to,
    row_range,
)
from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_map


def mesh_matvec_for(kernel, x: torch.Tensor, mesh: Mesh, axis: str = "tp",
                    block: int = 2048):
    """A ``V -> K(x, x) @ V`` closure over the mesh (V [n, r] or [n],
    replicated; the result replicated). The route and its hyperparameters
    are resolved once here, not per product."""
    n = x.shape[0]
    start, stop, rows = row_range(n, mesh, axis)
    x_loc = x[start:stop]
    local = fused_matvec_cross_for(kernel, x_loc, x, block) if stop > start \
        else None

    def mv(V):
        vec = V.ndim == 1
        Vm = V[:, None] if vec else V
        if local is None:
            out = Vm.new_zeros((0, Vm.shape[1]))
        else:
            out = local(Vm)
        out = all_gather_rows(pad_to(out, rows), mesh, axis)[:n]
        return out[:, 0] if vec else out

    return mv


def mesh_gram_matvec(kernel, x: torch.Tensor, V: torch.Tensor, mesh: Mesh,
                     axis: str = "tp", block: int = 2048) -> torch.Tensor:
    """K(x, x) @ V over the mesh: each rank computes its K(x_loc, x)·V
    panel, and the panels are all-gathered into the replicated [n, r]."""
    return mesh_matvec_for(kernel, x, mesh, axis, block)(V)


def mesh_lowrank_vjp_for(kernel, x: torch.Tensor, mesh: Mesh,
                         axis: str = "tp", block: int = 2048):
    """A ``(U, W) -> grads`` closure over the mesh: the gradient of
    Σᵢⱼ(UWᵀ)ᵢⱼK(x, x)ᵢⱼ with respect to the kernel's installed
    hyperparameters, as a params tree on every rank."""
    start, stop, _ = row_range(x.shape[0], mesh, axis)
    if stop > start:
        local = fused_lowrank_vjp_cross_for(kernel, x[start:stop], x, block)
    else:  # an empty panel contributes zeros
        def local(U, W):
            return tree_map(lambda p: torch.zeros_like(p.detach()),
                            kernel.get_params())

    def vjp(U, W):
        return all_reduce_tree(local(U[start:stop], W), mesh, axis)

    return vjp


def mesh_lowrank_vjp(kernel, x: torch.Tensor, U: torch.Tensor,
                     W: torch.Tensor, mesh: Mesh, axis: str = "tp",
                     block: int = 2048):
    """∂/∂θ of Σᵢⱼ(UWᵀ)ᵢⱼKᵢⱼ over the mesh (U, W: [n, r], replicated).
    Row i of the cotangent lives with row i of x, so each rank contracts
    (x_loc, U_loc) against (x, W) through K2 (SE, Matérn), K4 (composite
    expressions) or the streamed autograd version, and the parameter
    gradients are all-reduced over the axis."""
    return mesh_lowrank_vjp_for(kernel, x, mesh, axis, block)(U, W)
