"""Nested parameter trees: dicts of tensors, with tuples under operators.

The JAX package keeps hyperparameters as pytrees (``{"lengthscale": ℓ}``
for a leaf, ``{"children": (p0, p1)}`` for a mean operator). The port keeps
the same shapes as plain dicts and tuples; these helpers walk them.
"""
from __future__ import annotations

from typing import Callable, List


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
