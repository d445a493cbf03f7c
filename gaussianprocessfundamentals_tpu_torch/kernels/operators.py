"""Kernel composition operators of the PyTorch port: Sum and Product.

Counterpart of ``gaussianprocessfundamentals_tpu/kernels/operators.py:27-101``
(``Operator``, ``Sum``, ``Product``). An operator holds its children as
submodules, so ``.to(device)`` moves every leaf's hyperparameters; its
params tree is ``{"children": (p0, p1, ...)}``, the JAX package's pytree,
and each child module holds its own. ``ChangePoint`` is not ported yet.
"""
from __future__ import annotations

from torch import nn

from gaussianprocessfundamentals_tpu_torch.kernels.base import (
    ChildParams,
    Kernel,
    register_kernel,
)


class Operator(ChildParams, Kernel):
    """A node over child expressions (``terms``)."""

    def __init__(self, children=()):
        super().__init__()
        self._terms = nn.ModuleList(children)

    @property
    def terms(self):
        return tuple(self._terms)

    def bounds(self, xrange, n):
        los, his = zip(*(c.bounds(xrange, n) for c in self.terms))
        return {"children": tuple(los)}, {"children": tuple(his)}

    def x_rescale(self, params, shift, scale):
        return {"children": tuple(
            c.x_rescale(p, shift, scale)
            for c, p in zip(self.terms, params["children"]))}

    def __str__(self):
        return "(" + self._SEP.join(str(c) for c in self.terms) + ")"


@register_kernel
class Sum(Operator):
    """K = Σᵢ Kᵢ."""

    _SEP = " + "

    def gram(self, x1, x2):
        out = self.terms[0].gram(x1, x2)
        for c in self.terms[1:]:
            out = out + c.gram(x1, x2)
        return out

    def diag(self, x):
        out = self.terms[0].diag(x)
        for c in self.terms[1:]:
            out = out + c.diag(x)
        return out


@register_kernel
class Product(Operator):
    """K = ∏ᵢ Kᵢ elementwise."""

    _SEP = " * "

    def gram(self, x1, x2):
        out = self.terms[0].gram(x1, x2)
        for c in self.terms[1:]:
            out = out * c.gram(x1, x2)
        return out

    def diag(self, x):
        out = self.terms[0].diag(x)
        for c in self.terms[1:]:
            out = out * c.diag(x)
        return out
