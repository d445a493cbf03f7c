"""m(x) = 0."""
import torch

PARAMS = ()
SIGNED = ()


def start(r, xmin, xmax):
    return {}


def value(p, x):
    return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
