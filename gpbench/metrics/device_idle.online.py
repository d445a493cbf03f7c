"""Share of a traced stretch of requests in which no operation ran on the device (torch.profiler: one minus the union of the device's kernel intervals over the wall). The online cell."""
from gpbench.lib import readers

LAYER = "device"
UNIT = "%"
MOVES = "posterior_points_per_s.online"


def read(ctx):
    return readers.idle_percent(ctx)
