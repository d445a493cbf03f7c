"""Kernel-expression AST for the PyTorch port.

Counterpart of ``gaussianprocessfundamentals_tpu/kernels/base.py:55-213``.
A kernel is an ``nn.Module`` that holds its own hyperparameters as tensors
named as in the JAX package (``lengthscale``, ``variance``, ``c``), so
``.to(device, dtype)`` moves them with the module. ``gram(x1, x2)`` maps
``x1: [..., n, d]``, ``x2: [..., m, d]`` to ``[..., n, m]``.

The AST serialises to the same JSON as the JAX package (``to_dict`` /
``kernel_from_dict``, a change-point gate as its value string and a
partitioning model as its dict), so one spec builds a kernel in either
package; ``+``
and ``*`` build ``Sum`` and ``Product`` nodes (:mod:`.operators`), flattening
nested operators of the same type as the JAX package's ``_merge`` does
(``:200-209``).
"""
from __future__ import annotations

import contextlib
import enum
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
)

KERNEL_REGISTRY: Dict[str, type] = {}


def _as_xrange(xrange) -> np.ndarray:
    """Normalise an x-range spec to a float [d, 2] array of (min, max)."""
    arr = np.asarray(xrange, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.shape[-1] != 2:
        raise ValueError(f"xrange must be [d, 2], got {arr.shape}")
    return arr


def register_kernel(cls):
    """Register a kernel class for deserialisation by its class name."""
    KERNEL_REGISTRY[cls.__name__] = cls
    return cls


class HyperparameterModule(nn.Module):
    """A module whose hyperparameters are buffers named by
    :meth:`param_names` (None until set): kernels and means.

    Buffers, not ``nn.Parameter``s: a fit optimises a dict of unconstrained
    leaf tensors and installs the constrained values with
    :meth:`set_params` each step. An installed value keeps its autograd
    graph, so gradients reach the leaves through ``gram``, ``diag`` and
    ``mean``; :meth:`differentiable` installs leaves of its own where the
    gradient with respect to the natural parameters is wanted."""

    def param_names(self) -> Tuple[str, ...]:
        return ()

    def has_params(self) -> bool:
        return all(getattr(self, name) is not None
                   for name in self.param_names())

    def get_params(self) -> dict:
        """The hyperparameters as the JAX package's params tree."""
        return {name: getattr(self, name) for name in self.param_names()}

    def set_params(self, params: Dict[str, torch.Tensor]):
        """Set every hyperparameter from ``params`` (keys = param names)."""
        names = set(self.param_names())
        if set(params) != names:
            raise KeyError(
                f"{type(self).__name__} takes params {sorted(names)}, "
                f"got {sorted(params)}"
            )
        for name, v in params.items():
            setattr(self, name, torch.as_tensor(v))
        return self

    def num_params(self) -> int:
        """The number of scalar hyperparameters (BIC's parameter count)."""
        return sum(max(1, t.numel()) for t in tree_leaves(self.get_params()))

    @contextlib.contextmanager
    def differentiable(self):
        """Install detached leaf copies of the hyperparameters that require
        grad, and yield them as a params tree; the values installed before
        come back on exit."""
        before = self.get_params()
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), before)
        self.set_params(leaves)
        try:
            yield leaves
        finally:
            self.set_params(before)


class ChildParams:
    """Parameters of a node whose children hold their own (the kernel
    operators and ``MeanSum``): the params tree is ``{"children": (p0, p1,
    ...)}``, one tree per child in ``terms``, as the JAX package's."""

    def has_params(self):
        return all(c.has_params() for c in self.terms)

    def get_params(self):
        return {"children": tuple(c.get_params() for c in self.terms)}

    def set_params(self, params):
        if set(params) != {"children"} or len(params["children"]) != len(self.terms):
            raise KeyError(
                f"{type(self).__name__} of {len(self.terms)} children takes "
                "{'children': (p0, ...)} with one params tree per child"
            )
        for c, p in zip(self.terms, params["children"]):
            c.set_params(p)
        return self

    def init_params(self, xrange=None, n: int = 0, generator=None, dtype=None):
        return {"children": tuple(c.init_params(xrange, n, generator, dtype)
                                  for c in self.terms)}

    def positivity(self):
        return {"children": tuple(c.positivity() for c in self.terms)}


class LocatedChildParams(ChildParams):
    """:class:`ChildParams` plus the node's own ``locations``: the sorted-at-
    use change points on x[:, 0] of ``ChangePoint`` and ``MeanChangePoint``
    (``{"children": (p0, …), "locations": [k]}``, the JAX package's tree).
    The node registers a ``locations`` buffer."""

    def has_params(self):
        return super().has_params() and self.locations is not None

    def get_params(self):
        return {**super().get_params(), "locations": self.locations}

    def set_params(self, params):
        params = dict(params)
        if "locations" not in params:
            raise KeyError(f"{type(self).__name__} takes params "
                           "{'children': (...), 'locations': [k]}")
        locations = params.pop("locations")
        super().set_params(params)
        self.locations = torch.as_tensor(locations)
        return self

    def init_params(self, xrange=None, n: int = 0, generator=None, dtype=None):
        """The children's, and k = len(children) − 1 locations evenly
        spaced inside the range of x[:, 0] (default [0, 1])."""
        p = super().init_params(xrange, n, generator, dtype)
        xr = _as_xrange(xrange if xrange is not None else [[0.0, 1.0]])
        k = len(self.terms) - 1
        p["locations"] = torch.as_tensor(
            np.linspace(xr[0, 0], xr[0, 1], k + 2)[1:-1], dtype=_dt(dtype))
        return p

    def positivity(self):
        return {**super().positivity(), "locations": False}


class Kernel(HyperparameterModule):
    """Abstract kernel-expression node.

    ``_AST_FIELDS`` names the constructor arguments that define the node;
    they, and nothing else, go into :meth:`to_dict`.
    """

    _AST_FIELDS: Tuple[str, ...] = ()
    _SEP = ""  # an operator's infix in str() and canonical_str()
    # Sum and Product: canonical_str sorts the children's forms
    _COMMUTATIVE = False

    # --- evaluation ------------------------------------------------------
    def gram(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def diag(self, x: torch.Tensor) -> torch.Tensor:
        """Diagonal of ``gram(x, x)`` without building the matrix."""
        raise NotImplementedError

    def forward(self, x1, x2):
        return self.gram(x1, x2)

    # --- parameters ------------------------------------------------------
    def init_params(self, xrange, n: int, generator=None, dtype=None) -> dict:
        """Default (``generator=None``) or random initial hyperparameters,
        as a dict of tensors; :meth:`set_params` installs them."""
        raise NotImplementedError

    def positivity(self) -> dict:
        raise NotImplementedError

    def bounds(self, xrange, n: int):
        raise NotImplementedError

    def x_rescale(self, params: dict, shift, scale) -> dict:
        raise NotImplementedError

    # --- structure -------------------------------------------------------
    @property
    def terms(self) -> Tuple["Kernel", ...]:
        """The child expressions (none for a leaf). The JAX package's
        ``children``: that name is ``nn.Module``'s own iterator."""
        return ()

    # --- algebra sugar ---------------------------------------------------
    def __add__(self, other: "Kernel") -> "Kernel":
        from gaussianprocessfundamentals_tpu_torch.kernels.operators import Sum

        return Sum(_merge(self, other, Sum))

    def __mul__(self, other: "Kernel") -> "Kernel":
        from gaussianprocessfundamentals_tpu_torch.kernels.operators import (
            Product,
        )

        return Product(_merge(self, other, Product))

    # --- serialisation ---------------------------------------------------
    def to_dict(self) -> dict:
        d = {"type": type(self).__name__}
        for name in self._AST_FIELDS:
            v = getattr(self, name)
            d[name] = v.value if isinstance(v, enum.Enum) else v
        if self.terms:
            d["children"] = [c.to_dict() for c in self.terms]
        return d

    def __str__(self) -> str:
        return type(self).__name__.replace("Kernel", "")

    def canonical_str(self) -> str:
        """Canonical string form (``kernels/base.py:156-174`` of the JAX
        package): a leaf is its name, with ``~s`` when scaled; a Sum or
        Product sorts its children's forms, so expressions equal up to the
        order of their arguments share one string; any other operator is
        ``Name(child, …)`` in its children's order, which for ChangePoint
        and Partition is the order of the segments. Not a key for anything
        that depends on the parameter order."""
        name = type(self).__name__.replace("Kernel", "")
        if not self.terms:
            return name + ("~s" if getattr(self, "scaled", False) else "")
        parts = [c.canonical_str() for c in self.terms]
        if self._COMMUTATIVE:
            return "(" + self._SEP.join(sorted(parts)) + ")"
        return name + "(" + ", ".join(parts) + ")"


def kernel_from_dict(d: dict) -> Kernel:
    """Rebuild a kernel tree from :meth:`Kernel.to_dict` output (either
    package's)."""
    d = dict(d)
    name = d.pop("type")
    if name not in KERNEL_REGISTRY:
        raise NotImplementedError(
            f"kernel type {name!r} is not ported to the PyTorch package yet "
            f"(ported: {sorted(KERNEL_REGISTRY)})"
        )
    if "children" in d:
        d["children"] = tuple(kernel_from_dict(c) for c in d["children"])
    if isinstance(d.get("model"), dict):
        from gaussianprocessfundamentals_tpu_torch.kernels.partition import (
            partitioning_from_dict,
        )

        d["model"] = partitioning_from_dict(d["model"])
    if isinstance(d.get("gate"), str):
        from gaussianprocessfundamentals_tpu_torch.config import ChangePointGate

        d["gate"] = ChangePointGate(d["gate"])
    return KERNEL_REGISTRY[name](**d)


def _merge(a: Kernel, b: Kernel, op_cls) -> Tuple[Kernel, ...]:
    """Flatten nested same-type operators."""
    out = []
    for k in (a, b):
        out.extend(k.terms if type(k) is op_cls else (k,))
    return tuple(out)


def _dt(dtype):
    return dtype if dtype is not None else torch.get_default_dtype()
