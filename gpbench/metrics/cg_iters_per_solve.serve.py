"""CG iterations per solve (the y-solve and every chunk) over the request window, from Posterior.solve_stats. The batch cell."""
from gpbench.lib import readers

LAYER = "solver"
UNIT = "iters"
MOVES = "posterior_points_per_s"


def read(ctx):
    return readers.cg_iters(ctx)
