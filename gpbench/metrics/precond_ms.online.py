"""Milliseconds of each preconditioner build in the request window, on the device's clock (CUDA events at both ends), averaged. The online cell."""
from gpbench.lib import readers

LAYER = "preconditioner"
UNIT = "ms"
MOVES = "posterior_points_per_s.online"


def read(ctx):
    return readers.precond_ms(ctx)
