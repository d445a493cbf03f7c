"""k = (x − c)·(x' − c)ᵀ with a per-dimension offset c of any sign."""
import numpy as np
import torch

PARAMS = ("offset",)
SIGNED = ("offset",)
# two differences and a product
VALUE_OPS, PER_DIM_OPS = 3, 3
DERIV_OPS = {"offset": 3}


def start(r, xmin, xmax):
    return {"offset": (np.asarray(xmin, np.float64)
                       + np.asarray(xmax, np.float64)) / 2.0}


def value(p, x1, x2):
    return (x1 - p["offset"]) @ (x2 - p["offset"]).T


def diag(p, x):
    a = x - p["offset"]
    return torch.sum(a * a, dim=1)
