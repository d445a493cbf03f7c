"""The work counts and least times of the routers' logical calls, on small
shapes, against numbers worked by hand."""
import pytest

import gpbench_tiny  # noqa: F401  (puts the repository on the path)
from gpbench.lib import peaks, work

SE = {"type": "SquaredExponentialKernel", "dim": 1, "scaled": True}
MAUNA = {"type": "Sum", "children": [
    {"type": "Product", "children": [
        {"type": "SquaredExponentialKernel", "dim": 1, "scaled": True},
        {"type": "PeriodicKernel", "dim": 1, "scaled": False}]},
    {"type": "SquaredExponentialKernel", "dim": 1, "scaled": True},
    {"type": "LinearKernel", "dim": 1, "scaled": False},
    {"type": "WhiteNoiseKernel", "dim": 1, "scaled": True}]}


@pytest.mark.parametrize("n1,n2,symmetric,want", [
    (4, 4, True, 10),   # 4·5/2 unordered pairs, the diagonal included
    (4, 4, False, 16),
    (3, 7, False, 21),
    (100_000, 100_000, True, 5_000_050_000),
])
def test_evaluations_count_unordered_pairs(n1, n2, symmetric, want):
    assert work.evaluations(n1, n2, symmetric) == want


def test_operations_per_evaluation():
    # SE: d², ·(−½/ℓ²), exp (4 with the difference) and the variance
    assert work.value_ops(SE) == 5
    # SE·PER (5 + 7 + 1), SE (5), LIN (3), WN (1 + 1), three additions
    assert work.value_ops(MAUNA) == 13 + 5 + 3 + 2 + 3
    # value 5, ℓ's derivative 3 + 2, the variance's 0 + 2
    assert work.vjp_ops(SE) == 12


def test_se_gram_matvec_at_100k_is_bound_by_its_product():
    n, r = 100_000, 9
    t = work.least_time("gram_matvec", SE, n, n, r, 1, True)
    assert t == pytest.approx(2.0 * n * n * r / 165e12)
    assert t == pytest.approx(1.0909e-3, rel=1e-4)


def test_composite_gram_matvec_at_100k_is_bound_by_its_evaluations():
    n = 100_000
    t = work.least_time("gram_matvec", MAUNA, n, n, 9, 1, True)
    assert t == pytest.approx(n * (n + 1) / 2 * 26 / peaks.F32_FLOPS)


def test_dense_gram_is_bound_by_its_output_bytes():
    t = work.least_time("dense_gram", SE, 100_000, 256, 0, 1, False)
    want = (4 * (100_000 + 256) + 4 * 100_000 * 256) / peaks.HBM_BYTES_PER_S
    assert t == pytest.approx(want)


def test_lowrank_vjp_product_term():
    n, r = 1000, 276
    t = work.least_time("lowrank_vjp", SE, n, n, r, 1, True)
    assert t == pytest.approx(max(2.0 * n * n * r / 165e12,
                                  n * (n + 1) / 2 * 12 / 67e12,
                                  (4 * n + 2 * 4 * n * r + 16) / 3.35e12))


def test_no_special_function_ceiling():
    # the product's float32-accurate ceiling is the TF32 peak over three
    assert peaks.F32_ACCURATE_PRODUCT_FLOPS == pytest.approx(165e12)
    assert not [k for k in vars(peaks) if "SFU" in k or "EXP" in k]
