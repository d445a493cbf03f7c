"""Each cell end to end on the CPU at a tiny size through the harness's
own run, and the correctness check failing the faults planted under the
timed path: a step that returns its state unchanged, half of the rows left
out with the mean taken over the rest (fit cells), and every answer
altered where it is produced (posterior cells)."""
import pytest

import gpbench_tiny
from gpbench.lib import faults

FIT = ["se100k-fit", "mauna100k-fit"]
POSTERIOR = ["se100k-serve-batch", "se100k-serve-online"]


@pytest.mark.parametrize("workload", FIT + POSTERIOR)
def test_cell_runs_and_is_correct(workload):
    out = gpbench_tiny.run_tiny(workload, seed=2**31 + 11)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    names = {"setup_s", "peak_device_gib"} | (
        {"fit_step_s"} if workload in FIT else
        {"posterior_points_per_s", "posterior_p90_s"})
    assert names <= set(out["e2e"])
    for v in out["checks"].values():
        assert v["value"] <= v["limit"]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in FIT for f in faults.FIT_FAULTS] + [
    (w, f) for w in POSTERIOR for f in faults.POSTERIOR_FAULTS])
def test_planted_fault_is_not_correct(workload, fault):
    table = faults.FIT_FAULTS if workload in FIT else faults.POSTERIOR_FAULTS
    with table[fault]():
        out = gpbench_tiny.run_tiny(workload, seed=2**31 + 12)
    assert not out["correct"], out["checks"]
