"""The lower-precision control on the card: the reference in float32 with
TF32 matmuls, put in the program's place, is not correct by the cells'
limits (at a size a test run holds; the readings at the cells' own size
are taken by ``gpbench/calibrate.py``). Run on a machine with a card:

    python -m pytest gpbench/tests/test_gpbench_control.py -m cuda
"""
import pytest
import torch

import gpbench_tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control's TF32 runs on one")
    return "cuda"


def _small(workload):
    cell = gpbench_tiny.tiny_cell(workload)
    cell["config"]["n"] = 20_000
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["se100k-fit", "mauna100k-fit"])
def test_fit_control_fails(card, workload):
    from gpbench.lib import check
    from gpbench.traffic.kinds import fit

    cell = _small(workload)
    limits = cell["config"]["limits"]["fit"]
    with gpbench_tiny.iterative_route():
        rows = dict(fit.readings(cell, 2**31 + 3, card, True, False))
    ok, _ = check.verdict(
        {k: v for k, v in rows["control_tf32"].items() if k in limits}, limits)
    assert not ok


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["se100k-serve-batch"])
def test_posterior_control_fails(card, workload):
    from gpbench.lib import check
    from gpbench.traffic.kinds import posterior

    cell = _small(workload)
    with gpbench_tiny.iterative_route():
        rows = dict(posterior.readings(cell, 2**31 + 3, card, True, False))
    ok, _ = check.verdict(rows["control_tf32"],
                          cell["config"]["limits"]["posterior"])
    assert not ok
