"""k = exp(−½‖x − x'‖² / ℓ²)."""
import torch

from gpbench.reference.leaves import distance_sq, ones

PARAMS = ("lengthscale",)
SIGNED = ()
# d² (a difference and a square), ·(−½/ℓ²), exp; a further dimension adds
# a difference, a square and a sum
VALUE_OPS, PER_DIM_OPS = 4, 3
DERIV_OPS = {"lengthscale": 3}


def start(r, xmin, xmax):
    return {"lengthscale": r / 10.0}


def value(p, x1, x2):
    ls = p["lengthscale"]
    return torch.exp(distance_sq(x1, x2) * (-0.5 / (ls * ls)))


def diag(p, x):
    return ones(x)
