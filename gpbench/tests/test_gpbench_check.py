"""The fit check's step-guard numbers on hand-made records: a skip counts
against the program where the reference decided otherwise, or where the
program's own rule, applied to what its guard read, decided otherwise."""
import pytest
import torch

import gpbench_tiny  # noqa: F401  (puts the repository on the path)
from gpbench.lib import check

GUARD = 0.5


def _side(skipped, medians, grads=(1.0, 2.0)):
    g = [torch.tensor([v], dtype=torch.float64) for v in grads]
    return {"nll": [10.0] * len(skipped), "first_raw": g,
            "first_grads": [t * 0 if skipped[0] else t for t in g],
            "u": [torch.zeros(1, dtype=torch.float64)] * 2,
            "sv": [torch.ones(3)] * len(skipped), "resid_median": medians,
            "finite": [True] * len(skipped), "skipped": skipped}


def _want(skipped, medians):
    w = _side(skipped, medians)
    w["u0"] = [torch.full((1,), -1.0, dtype=torch.float64)] * 2
    w["tr"] = [10.0] * len(skipped)
    return w


@pytest.mark.parametrize("got,want,mismatch", [
    # the same decisions, each by the rule
    (([False, True, False], [0.1, 0.6, 0.2]),
     ([False, True, False], [0.1, 0.6, 0.2]), 0),
    # every step skipped: two against the reference and the rule
    (([True, True, True], [0.1, 0.6, 0.2]),
     ([False, True, False], [0.1, 0.6, 0.2]), 2),
    # the reference took the program's decision at a straddle (0.49 / 0.51),
    # which the program's rule contradicts
    (([True, False, False], [0.49, 0.1, 0.1]),
     ([True, False, False], [0.51, 0.1, 0.1]), 1),
])
def test_skip_mismatch(got, want, mismatch):
    nums = check.fit_gaps(_side(*got), _want(*want), GUARD)
    assert nums["skip_mismatch"] == mismatch


def test_gradient_is_compared_before_the_guard():
    # both sides skipped step 0: the optimiser's gradients are zero on both,
    # the gradient before the guard still differs
    got = _side([True], [0.7], grads=(1.0, 3.0))
    want = _want([True], [0.7])
    assert check.fit_gaps(got, want, GUARD)["grad_gap"] == pytest.approx(0.5)
