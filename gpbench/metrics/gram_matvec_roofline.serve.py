"""Gram·V calls of the request window (K1): their least seconds over their device seconds (CUDA events around each call). The batch cell."""
from gpbench.lib import readers

LAYER = "kernels"
UNIT = "%"
MOVES = "posterior_points_per_s"


def read(ctx):
    return readers.roofline_percent(ctx, "gram_matvec")
