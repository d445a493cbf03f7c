"""Constraint handling by log-reparameterisation.

Counterpart of ``gaussianprocessfundamentals_tpu/fit/transforms.py:17-39``:
positive hyperparameters are optimised in log space, and box bounds are a
clip in that space. Parameters are trees of tensors (dicts, with tuples
under operators) beside a positivity tree of the same shape.
"""
from __future__ import annotations

import torch

from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
)


def leaf_copy(tree, project_fn=None):
    """A copy of ``tree`` made of fresh leaf tensors that require grad (the
    optimisers' state), projected when a projection is given."""
    u = tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)
    if project_fn is not None:
        assign_leaves(u, project_fn(u))
    return u


def assign_leaves(u, new):
    """Copy the values of tree ``new`` into the leaf tensors of ``u``."""
    with torch.no_grad():
        for p, v in zip(tree_leaves(u), tree_leaves(new)):
            p.copy_(v)


def unconstrain(positivity, params):
    """Natural → optimisation space (log where positive)."""
    return tree_map(lambda p, pos: torch.log(p) if pos else p,
                    params, positivity)


def constrain(positivity, uparams):
    """Optimisation → natural space (exp where positive)."""
    return tree_map(lambda p, pos: torch.exp(p) if pos else p,
                    uparams, positivity)


def clip_to_bounds(params, lower, upper):
    """Project params into [lower, upper] box bounds."""
    def clip(p, lo, hi):
        lo = torch.as_tensor(lo, dtype=p.dtype, device=p.device)
        hi = torch.as_tensor(hi, dtype=p.dtype, device=p.device)
        return torch.minimum(torch.maximum(p, lo), hi)

    return tree_map(clip, params, lower, upper)
