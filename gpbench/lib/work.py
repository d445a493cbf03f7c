"""The work of one logical call of the program's kernel routers, counted
from the problem (shapes and the covariance's expression), never from the
implementation that serves it; and its least time on the card.

Least time = the largest of
  product:     2·n1·n2·r operations / the float32-accurate product peak;
  evaluation:  kernel evaluations × operations per evaluation / the
               float32 peak, one evaluation per unordered pair where both
               sides are the training inputs (the Gram is symmetric), else
               n1·n2;
  bytes:       each input byte read once, each output byte written once /
               the memory rate.
"""
from __future__ import annotations

from gpbench.lib import peaks
from gpbench.reference.leaves import leaf

# a scaled leaf multiplies by its variance (whose derivative is the
# unscaled value: no extra operations); the VJP multiplies each derivative
# by the cotangent and adds it to that parameter's sum. A leaf's own counts
# are in its reference file (gpbench/reference/leaves/<type>.py).
SCALE_OPS = 1
ACCUMULATE_OPS = 2


def _leaf_params(desc: dict) -> list:
    own = list(leaf(desc["type"]).PARAMS)
    return own + (["variance"] if desc.get("scaled") else [])


def value_ops(desc: dict, d: int = 1) -> int:
    """Operations per pair to evaluate the covariance."""
    t = desc["type"]
    if t in ("Sum", "Product"):
        kids = desc["children"]
        return sum(value_ops(c, d) for c in kids) + len(kids) - 1
    lf = leaf(t)
    base, per_dim = lf.VALUE_OPS, lf.PER_DIM_OPS
    return base + per_dim * (d - 1) + (SCALE_OPS if desc.get("scaled") else 0)


def vjp_ops(desc: dict, d: int = 1) -> int:
    """Operations per pair for the value and every parameter's derivative,
    each multiplied by the cotangent and accumulated."""
    t = desc["type"]
    if t in ("Sum", "Product"):
        # a Product's derivative multiplies by the other factors' values
        extra = len(desc["children"]) - 1 if t == "Product" else 0
        return (sum(vjp_ops(c, d) for c in desc["children"])
                + len(desc["children"]) - 1 + extra * n_params(desc))
    deriv = dict(leaf(t).DERIV_OPS, variance=0)
    return value_ops(desc, d) + sum(
        deriv[p] + ACCUMULATE_OPS for p in _leaf_params(desc))


def n_params(desc: dict) -> int:
    if desc["type"] in ("Sum", "Product"):
        return sum(n_params(c) for c in desc["children"])
    return len(_leaf_params(desc))


def evaluations(n1: int, n2: int, symmetric: bool) -> int:
    """Kernel evaluations the inputs need: one per unordered pair (the
    diagonal included) when both sides are the training inputs."""
    return n1 * (n1 + 1) // 2 if symmetric else n1 * n2


def least_time(kind: str, desc: dict, n1: int, n2: int, r: int, d: int,
               symmetric: bool, itemsize: int = 4) -> float:
    """Least seconds of one logical call on the card. ``kind``:
    "gram_matvec" (K(x1, x2)·V, V [n2, r]), "lowrank_vjp" (the parameter
    gradient of Σ(UWᵀ)∘K(x1, x2), U [n1, r], W [n2, r]) or "dense_gram"
    (K(x1, x2) written out)."""
    ev = evaluations(n1, n2, symmetric)
    inputs = (n1 + (0 if symmetric else n2)) * d * itemsize
    if kind == "gram_matvec":
        flops, ops = 2.0 * n1 * n2 * r, value_ops(desc, d)
        nbytes = inputs + n2 * r * itemsize + n1 * r * itemsize
    elif kind == "lowrank_vjp":
        flops, ops = 2.0 * n1 * n2 * r, vjp_ops(desc, d)
        nbytes = inputs + (n1 + n2) * r * itemsize + n_params(desc) * 8
    elif kind == "dense_gram":
        flops, ops = 0.0, value_ops(desc, d)
        nbytes = inputs + n1 * n2 * itemsize
    else:
        raise ValueError(f"unknown call kind {kind}")
    return max(flops / peaks.F32_ACCURATE_PRODUCT_FLOPS,
               ev * ops / peaks.F32_FLOPS,
               nbytes / peaks.HBM_BYTES_PER_S)
