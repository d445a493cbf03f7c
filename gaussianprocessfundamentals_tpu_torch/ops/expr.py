"""The host-side half of the composite-expression engine: which expressions
the generated kernels cover, the packed parameter vector, the white-noise
algebra, and the plain PyTorch versions of K3 and K4.

Counterpart of ``gaussianprocessfundamentals_tpu/ops/pallas_expr.py``:
``supported_expr`` (``:78-128``), ``split_white_noise`` (``:131-171``),
``_leaf_param_names`` / ``_walk_leaves`` / ``pack_params`` /
``unpack_grads`` (``:174-251``) and ``_wn_exact_matvec`` (``:544-570``).
The kernels themselves are generated per expression
(:mod:`.expr_codegen`) and launched by :mod:`.cuda_expr`.

Parameters are packed depth-first over the leaves, each leaf's in a fixed
order (its own parameters, then ``variance`` when scaled), so a flat
gradient maps back by position. That order is the order of
``tree_leaves(kernel.get_params())`` and of the JAX package's packing.

A WhiteNoise leaf directly under the root Sum (or a WhiteNoise root) is
stripped and handled exactly: its Gram is the row-coincidence matrix Eq
(Eqᵢⱼ = 1 iff xᵢ ≡ xⱼ in every dimension), so Eq·V and Σ(UWᵀ)∘Eq are sums
over groups of equal rows (:class:`RowGroups`), O(n·r) once the grouping is
known. The grouping is computed once per router, not per product.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from gaussianprocessfundamentals_tpu_torch.kernels import leaves as lv
from gaussianprocessfundamentals_tpu_torch.kernels.operators import (
    Product,
    Sum,
)
from gaussianprocessfundamentals_tpu_torch.ops.gram_matvec import (
    lowrank_gram_vjp_cross,
    streamed_gram_matvec_cross,
)
from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_unflatten,
)

MAX_D = 8  # the generated tile code unrolls over the input dimensions
MAX_PARAMS = 126  # the JAX package's packed-vector capacity

LEAF_KINDS = {
    lv.SquaredExponentialKernel: "se",
    lv.PeriodicKernel: "per",
    lv.LinearKernel: "lin",
    lv.Matern32Kernel: "mat32",
    lv.Matern52Kernel: "mat52",
    lv.RationalQuadraticKernel: "rq",
    lv.ConstantKernel: "const",
}
# pack order of each kind's own parameters (``variance`` follows when scaled)
PARAM_NAMES = {
    "se": ("lengthscale",),
    "per": ("lengthscale", "period"),
    "lin": ("offset",),
    "mat32": ("lengthscale",),
    "mat52": ("lengthscale",),
    "rq": ("lengthscale", "alpha"),
    "const": ("c",),
}
# parameters that may be per-dimension vectors (ARD); every other one must
# be a scalar, or the tile code would read only its first component
ARD_OK = {("se", "lengthscale"), ("mat32", "lengthscale"),
          ("mat52", "lengthscale"), ("rq", "lengthscale"), ("lin", "offset")}
COVERED = "Sum and Product of SE, PER, LIN, MAT32, MAT52, RQ and CONST leaves"


def walk_leaves(kernel) -> Iterator:
    """The leaves of an expression, depth first."""
    if kernel.terms:
        for c in kernel.terms:
            yield from walk_leaves(c)
    else:
        yield kernel


def _size(t: torch.Tensor) -> int:
    return max(1, t.numel())


def layout(kernel) -> List[Tuple[str, dict, bool]]:
    """Per leaf, depth first: (kind, {param name: (offset, size)}, scaled),
    the offsets into the packed vector."""
    out, off = [], 0
    for leaf in walk_leaves(kernel):
        kind = LEAF_KINDS[type(leaf)]
        slots = {}
        names = PARAM_NAMES[kind] + (("variance",) if leaf.scaled else ())
        for name in names:
            sz = _size(getattr(leaf, name))
            slots[name] = (off, sz)
            off += sz
        out.append((kind, slots, leaf.scaled))
    return out


def _sum_product_leaves(kernel) -> Iterator:
    """The nodes below the Sum and Product nodes of an expression: leaves,
    and the first operator of any other kind on each branch."""
    if type(kernel) in (Sum, Product):
        for c in kernel.terms:
            yield from _sum_product_leaves(c)
    else:
        yield kernel


def malformed(kernel, d: int) -> Optional[str]:
    """What is wrong with the parameters of the covered leaves below the
    Sum and Product nodes of ``kernel`` at input dimension ``d`` (None when
    nothing is): a parameter not set, of a shape that is neither a scalar
    nor one per dimension, or per-dimension where the leaf takes a scalar.
    Such a kernel is not a valid covariance on any route."""
    for k in _sum_product_leaves(kernel):
        if k.terms or type(k) not in LEAF_KINDS:
            continue
        kind = LEAF_KINDS[type(k)]
        for name in PARAM_NAMES[kind] + (("variance",) if k.scaled else ()):
            v = getattr(k, name)
            if v is None:
                return f"{type(k).__name__}.{name} is not set"
            if v.ndim > 1 or (v.ndim == 1 and v.numel() not in (1, d)):
                return f"{type(k).__name__}.{name} has shape {tuple(v.shape)}"
            if v.ndim == 1 and v.numel() > 1 and (kind, name) not in ARD_OK:
                return f"{type(k).__name__}.{name} cannot be per-dimension"
    return None


def uncovered(kernel, d: int) -> Optional[str]:
    """What the generated kernels' tile code does not cover in ``kernel``
    at input dimension ``d``, parameters aside (None when it covers the
    expression): d > MAX_D, an operator other than Sum and Product, a leaf
    with no tile evaluator (WhiteNoise below the root Sum among them), or
    more than MAX_PARAMS packed parameters. WhiteNoise must have been
    stripped from the root first (:func:`split_white_noise`)."""
    if d > MAX_D:
        return f"d={d} > {MAX_D}: the tile code unrolls over the dimensions"
    for k in _sum_product_leaves(kernel):
        if k.terms:
            return (f"{type(k).__name__} is an operator the tile code does "
                    f"not evaluate (covered: {COVERED}; the JAX package "
                    "streams it through XLA)")
        if type(k) not in LEAF_KINDS:
            where = (" below the root Sum" if type(k) is lv.WhiteNoiseKernel
                     else "")
            return (f"{type(k).__name__}{where} has no tile evaluator "
                    f"(covered: {COVERED}; WhiteNoise only at the root Sum)")
    if malformed(kernel, d) is not None:
        return None  # no packed layout to count
    p = sum(sz for _, slots, _ in layout(kernel) for _, sz in slots.values())
    if p > MAX_PARAMS:
        return f"{p} packed parameters > {MAX_PARAMS}"
    return None


def unsupported(kernel, d: int) -> Optional[str]:
    """What keeps the generated kernels from covering ``kernel`` at input
    dimension ``d`` (None when they cover it): a gap in their coverage
    (:func:`uncovered`) or malformed parameters (:func:`malformed`).
    WhiteNoise must have been stripped from the root first
    (:func:`split_white_noise`)."""
    return uncovered(kernel, d) or malformed(kernel, d)


def supported_expr(kernel, d: int) -> bool:
    """True when every node of the expression has a tile evaluator."""
    return unsupported(kernel, d) is None


def split_white_noise(kernel):
    """Strip WhiteNoise leaves from a root Sum (or a bare WhiteNoise root).

    Returns ``(core, wn_leaves)``: ``core`` is the expression without those
    leaves (None if nothing remains; the kernel itself when it has none),
    sharing the original child modules and so their parameters."""
    if type(kernel) is lv.WhiteNoiseKernel:
        return None, [kernel]
    if type(kernel) is not Sum:
        return kernel, []
    keep = [c for c in kernel.terms if type(c) is not lv.WhiteNoiseKernel]
    wn = [c for c in kernel.terms if type(c) is lv.WhiteNoiseKernel]
    if not wn:
        return kernel, []
    if not keep:
        return None, wn
    if len(keep) == 1:
        return keep[0], wn
    return Sum(keep), wn


def wn_amplitude(wn_leaves, like: torch.Tensor) -> torch.Tensor:
    """The summed amplitude of the stripped WhiteNoise leaves (1 for an
    unscaled one), as a tensor on ``like``'s device: no host read."""
    amp = torch.zeros((), dtype=like.dtype, device=like.device)
    for leaf in wn_leaves:
        amp = amp + (leaf.variance.detach().to(like) if leaf.scaled else 1.0)
    return amp


def pack_params(kernel) -> torch.Tensor:
    """The leaves' hyperparameters as one float32 vector in pack order, on
    the device that holds them."""
    return torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tree_leaves(kernel.get_params())])


def unpack_grads(kernel, gvec: torch.Tensor) -> dict:
    """Inverse of :func:`pack_params` for a flat gradient: a tree shaped and
    typed like ``kernel.get_params()``."""
    template = tree_leaves(kernel.get_params())
    out, pos = [], 0
    for t in template:
        sz = _size(t)
        out.append(gvec[pos:pos + sz].reshape(t.shape).to(t.dtype))
        pos += sz
    return tree_unflatten(kernel.get_params(), out)


def with_white_noise(kernel, g_core, wn_grad) -> dict:
    """The gradient tree of ``kernel`` (a WhiteNoise root, or a root Sum with
    WhiteNoise children) from its stripped core's (``g_core``, None when
    nothing remains) and the stripped leaves' shared contraction
    Σ(UWᵀ)∘Eq (``wn_grad``, the gradient of each scaled WhiteNoise
    variance)."""
    def wn(leaf):
        return {"variance": wn_grad.to(leaf.variance.dtype)} if leaf.scaled else {}

    if type(kernel) is lv.WhiteNoiseKernel:
        return wn(kernel)
    n_keep = sum(type(c) is not lv.WhiteNoiseKernel for c in kernel.terms)
    core_children = iter(g_core["children"] if n_keep > 1
                         else (g_core,) if n_keep == 1 else ())
    return {"children": tuple(
        wn(c) if type(c) is lv.WhiteNoiseKernel else next(core_children)
        for c in kernel.terms)}


class RowGroups:
    """The exact row-coincidence pattern between x1 and x2 (x2 = x1 when not
    given): rows equal in every dimension share a group. Built once (one
    sort); then Eq(x1, x2)·V and Σᵢⱼ (UWᵀ)ᵢⱼ·Eqᵢⱼ are group sums, O(n·r)."""

    def __init__(self, x1: torch.Tensor, x2: Optional[torch.Tensor] = None):
        rows = x1 if x2 is None else torch.cat([x1, x2])
        uniq, inv = torch.unique(rows, dim=0, return_inverse=True)
        self.n_groups = uniq.shape[0]
        self.inv1 = inv[:x1.shape[0]]
        self.inv2 = self.inv1 if x2 is None else inv[x1.shape[0]:]

    def _sums(self, inv, V):
        S = torch.zeros((self.n_groups,) + tuple(V.shape[1:]), dtype=V.dtype,
                        device=V.device)
        return S.index_add_(0, inv, V)

    def matvec(self, V: torch.Tensor) -> torch.Tensor:
        """Eq(x1, x2) @ V; V: [n2, r] or [n2]."""
        return self._sums(self.inv2, V)[self.inv1]

    def contract(self, U: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        """Σᵢⱼ (UWᵀ)ᵢⱼ·Eq(x1, x2)ᵢⱼ = Σ_groups Σₖ (Σ_{i∈g} Uᵢₖ)(Σ_{j∈g} Wⱼₖ),
        the products summed in float64."""
        su = self._sums(self.inv1, U).double()
        sw = self._sums(self.inv2, W).double()
        return torch.sum(su * sw).to(U.dtype)


def plain_expr_gram_matvec_cross(kernel, x1, x2, V, block: int = 2048):
    """K3 in plain PyTorch: row panels of the expression's Gram times V
    (``ops/gram_matvec.py:22-33``)."""
    return streamed_gram_matvec_cross(kernel, x1, x2, V, block)


def plain_expr_lowrank_vjp_cross(kernel, x1, x2, U, W, block: int = 2048):
    """K4 in plain PyTorch: ∂/∂pv of Σᵢⱼ (UWᵀ)ᵢⱼ K(x1, x2)ᵢⱼ as a flat vector
    in pack order, by autograd over row panels of the Gram
    (``ops/gram_matvec.py:53-73``): independent of the generated code."""
    g = lowrank_gram_vjp_cross(kernel, x1, x2, U, W, block)
    return torch.cat([t.reshape(-1) for t in tree_leaves(g)])
