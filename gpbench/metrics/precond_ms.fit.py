"""Milliseconds of each preconditioner build in the fit window, on the device's clock (CUDA events at both ends), averaged."""
from gpbench.lib import readers

LAYER = "preconditioner"
UNIT = "ms"
MOVES = "fit_step_s"


def read(ctx):
    return readers.precond_ms(ctx)
