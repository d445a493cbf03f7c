"""k = exp(−2 sin²(π·d / p) / ℓ²), d the Manhattan distance."""
import math

import torch

from gpbench.reference.leaves import manhattan, ones

PARAMS = ("lengthscale", "period")
SIGNED = ()
# |d|, ·π/p, sin, square, ·(−2/ℓ²), exp
VALUE_OPS, PER_DIM_OPS = 7, 2
DERIV_OPS = {"lengthscale": 3, "period": 4}


def start(r, xmin, xmax):
    return {"lengthscale": r / 10.0, "period": r / 10.0}


def value(p, x1, x2):
    s = torch.sin(manhattan(x1, x2) * (math.pi / p["period"]))
    ls = p["lengthscale"]
    return torch.exp(s * s * (-2.0 / (ls * ls)))


def diag(p, x):
    return ones(x)
