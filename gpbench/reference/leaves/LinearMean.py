"""m(x) = Σ_d slope_d·x_d."""
import numpy as np

PARAMS = ("slope",)
SIGNED = ("slope",)


def start(r, xmin, xmax):
    d = len(xmin)
    return {"slope": np.full((d,), 1.0 / d)}


def value(p, x):
    return x @ p["slope"]
