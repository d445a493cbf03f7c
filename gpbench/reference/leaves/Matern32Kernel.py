"""k = (1 + √3·d/ℓ)·exp(−√3·d/ℓ), d the Manhattan distance."""
import math

import torch

from gpbench.reference.leaves import manhattan, ones

PARAMS = ("lengthscale",)
SIGNED = ()
# |d|, ·√3/ℓ, 1 +, exp(−), the product
VALUE_OPS, PER_DIM_OPS = 6, 2
DERIV_OPS = {"lengthscale": 3}


def start(r, xmin, xmax):
    return {"lengthscale": r / 10.0}


def value(p, x1, x2):
    f = manhattan(x1, x2) * (math.sqrt(3.0) / torch.abs(p["lengthscale"]))
    return (1.0 + f) * torch.exp(-f)


def diag(p, x):
    return ones(x)
