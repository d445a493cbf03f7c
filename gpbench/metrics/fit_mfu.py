"""The fit window's share of the card's peak: the least seconds of every counted Gram·V, VJP and Gram-build call over the window's wall."""
from gpbench.lib import readers

LAYER = "whole step"
UNIT = "%"
MOVES = "fit_step_s"


def read(ctx):
    return readers.mfu_percent(ctx)
