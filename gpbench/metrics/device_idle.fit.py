"""Share of a traced fit call in which no operation ran on the device (torch.profiler: one minus the union of the device's kernel intervals over the wall)."""
from gpbench.lib import readers

LAYER = "device"
UNIT = "%"
MOVES = "fit_step_s"


def read(ctx):
    return readers.idle_percent(ctx)
