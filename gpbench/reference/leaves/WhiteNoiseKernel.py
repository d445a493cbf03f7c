"""k = 1 where every coordinate of the two points is equal, else 0."""
import torch

from gpbench.reference.leaves import ones

PARAMS = ()
SIGNED = ()
# an equality test
VALUE_OPS, PER_DIM_OPS = 1, 1
DERIV_OPS = {}


def start(r, xmin, xmax):
    return {}


def value(p, x1, x2):
    k = torch.ones((), dtype=x1.dtype, device=x1.device)
    for j in range(x1.shape[1]):
        k = k * (x1[:, j:j + 1] == x2[:, j][None, :]).to(x1.dtype)
    return k


def diag(p, x):
    return ones(x)
