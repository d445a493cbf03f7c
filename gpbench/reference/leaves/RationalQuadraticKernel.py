"""k = (1 + ‖x − x'‖² / (2αℓ²))^(−α)."""
import torch

from gpbench.reference.leaves import distance_sq, ones

PARAMS = ("alpha", "lengthscale")
SIGNED = ()
# d² (a difference and a square), ·1/(2αℓ²), 1 +, log, ·(−α), exp
VALUE_OPS, PER_DIM_OPS = 7, 3
DERIV_OPS = {"lengthscale": 3, "alpha": 5}


def start(r, xmin, xmax):
    return {"lengthscale": r / 10.0, "alpha": 1.0}


def value(p, x1, x2):
    al, ls = p["alpha"], p["lengthscale"]
    return torch.pow(1.0 + distance_sq(x1, x2) / (2.0 * al * ls * ls), -al)


def diag(p, x):
    return ones(x)
