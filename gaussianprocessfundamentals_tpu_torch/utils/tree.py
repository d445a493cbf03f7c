"""Nested parameter trees: dicts of tensors, with tuples under operators.

The JAX package keeps hyperparameters as pytrees (``{"lengthscale": ℓ}``
for a leaf, ``{"children": (p0, p1)}`` for a mean operator). The port keeps
the same shapes as plain dicts and tuples; these helpers walk them, and
:func:`ravel_tree` flattens one to a vector in ``ravel_pytree``'s order.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, List

import torch


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and trees of the same shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """The leaves of ``tree`` in the order :func:`tree_map` visits them."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _sorted_leaves(tree) -> List:
    """The leaves of ``tree`` in JAX's pytree order: dict keys sorted."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _sorted_leaves(v)]
    return [tree]


def _sorted_unflatten(tree, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def ravel_tree(tree, batch_ndim: int = 0):
    """``(flat, unravel)``: the leaves of ``tree`` flattened and concatenated
    in the order of JAX's ``ravel_pytree`` (dict keys sorted), after their
    first ``batch_ndim`` dimensions, which every leaf shares: a stacked tree
    (every leaf [C, ...]) with ``batch_ndim=1`` gives [C, dim].
    ``unravel(v)`` takes v [..., dim] with any leading dimensions and
    returns the tree with leaves [..., *shape]."""
    leaves = [torch.as_tensor(leaf) for leaf in _sorted_leaves(tree)]
    if not leaves:
        raise ValueError("ravel_tree needs a tree with at least one leaf")
    batch = leaves[0].shape[:batch_ndim]
    shapes = [leaf.shape[batch_ndim:] for leaf in leaves]
    sizes = [math.prod(s) for s in shapes]
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in leaves))
    flat = torch.cat([leaf.reshape(*batch, -1).to(dtype) for leaf in leaves],
                     dim=-1)

    def unravel(v):
        out, off = [], 0
        for shape, size in zip(shapes, sizes):
            out.append(v[..., off:off + size].reshape(v.shape[:-1] + shape))
            off += size
        return _sorted_unflatten(tree, out)

    return flat, unravel
