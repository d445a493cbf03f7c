"""Gram·V calls of the fit window (K1 or K3): their least seconds over their device seconds (CUDA events around each call)."""
from gpbench.lib import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "fit_step_s"


def read(ctx):
    return readers.roofline_percent(ctx, "gram_matvec")
