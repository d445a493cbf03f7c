"""k = (1 + √5·d/ℓ + 5d²/3ℓ²)·exp(−√5·d/ℓ), d the Manhattan distance."""
import math

import torch

from gpbench.reference.leaves import manhattan, ones

PARAMS = ("lengthscale",)
SIGNED = ()
# |d|, ·√5/ℓ, its square, ·⅓, two sums, exp(−), the product
VALUE_OPS, PER_DIM_OPS = 9, 2
DERIV_OPS = {"lengthscale": 3}


def start(r, xmin, xmax):
    return {"lengthscale": r / 10.0}


def value(p, x1, x2):
    dd = manhattan(x1, x2) / torch.abs(p["lengthscale"])
    f = math.sqrt(5.0) * dd
    return (1.0 + f + 5.0 * dd * dd / 3.0) * torch.exp(-f)


def diag(p, x):
    return ones(x)
