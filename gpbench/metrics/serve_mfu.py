"""The request window's share of the card's peak: the least seconds of every counted Gram·V, VJP and Gram-build call over the window's wall. The batch cell."""
from gpbench.lib import readers

LAYER = "whole step"
UNIT = "%"
MOVES = "posterior_points_per_s"


def read(ctx):
    return readers.mfu_percent(ctx)
