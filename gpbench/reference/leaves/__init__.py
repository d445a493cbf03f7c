"""Leaves of the reference's covariance and mean grammar, one file each,
found by the leaf's ``type`` name (``<type>.py`` here). A covariance leaf
gives ``PARAMS`` (its own parameters, sorted), ``SIGNED`` (those that take
any sign; the rest are optimised in log space), ``start(r, xmin, xmax)``
(the stated starting point; ``r`` is the range of the first input
dimension), ``value(p, x1, x2)`` and ``diag(p, x)``, and for the work
counts of ``gpbench/lib/work.py`` ``VALUE_OPS`` and ``PER_DIM_OPS`` (float32
operations per evaluation at d = 1, a transcendental counted as one, and
what each further dimension adds) and ``DERIV_OPS`` (per own parameter,
its derivative's extra operations). A mean leaf gives ``PARAMS``,
``SIGNED``, ``start`` and ``value(p, x)``. A scaled leaf's variance is the
grammar's (``gpbench/reference/gp.py``)."""
from __future__ import annotations

import importlib


def leaf(type_name: str):
    """The module of leaf ``type_name``."""
    try:
        return importlib.import_module(f"{__name__}.{type_name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{type_name}":
            raise
        raise ValueError(f"no reference for {type_name!r}: add "
                         f"gpbench/reference/leaves/{type_name}.py") from None


def distance_sq(x1, x2):
    """Squared Euclidean distances [n1, n2], one dimension at a time."""
    d2 = None
    for j in range(x1.shape[1]):
        dj = x1[:, j:j + 1] - x2[:, j][None, :]
        d2 = dj * dj if d2 is None else d2 + dj * dj
    return d2


def manhattan(x1, x2):
    """Manhattan distances [n1, n2], one dimension at a time."""
    out = None
    for j in range(x1.shape[1]):
        dj = (x1[:, j:j + 1] - x2[:, j][None, :]).abs()
        out = dj if out is None else out + dj
    return out


def ones(x):
    import torch

    return torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
