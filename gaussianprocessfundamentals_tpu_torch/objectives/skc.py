"""SKC (Scalable Kernel Compositions) log-likelihood bounds.

Counterpart of ``gaussianprocessfundamentals_tpu/objectives/skc.py``:
``skc_upper_bound`` (``:32``) and ``skc_lower_bound`` (``:104``). The lower
bound is the Nyström log likelihood with the Titsias trace correction. The
upper bound is the partially optimised variational quadratic

    ½·αᵀ(K̂+σ²I)α − αᵀy − ½·log|K̂+σ²I| − (n/2)·log 2π

after ``num_iters`` CG steps from α = 1 on the Woodbury-factored K̂. For
any α the quadratic bounds the data fit −½yᵀ(K̂+σ²I)⁻¹y from above, and
K̂ ⪯ K makes −½log|K̂+σ²I| bound the complexity term from above; but the
quadratic's *minimum* sits below the true data fit −½yᵀ(K+σ²I)⁻¹y, so a
fully optimised α could undershoot. The early stop is what keeps it an
upper bound in practice: the JAX package's adversarial test
(``tests/test_block_cholesky.py::test_skc_upper_bound_adversarial``)
measured violations of up to −3019 at σ² = 1e-6 once the inner CG runs 20
steps or more.
"""
from __future__ import annotations

import torch

from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import LOG_2PI
from gaussianprocessfundamentals_tpu_torch.linalg.nystroem import (
    nystroem_factor,
    nystroem_logdet,
    nystroem_mll,
)


def skc_upper_bound(kernel, x, y, z, noise, jitter: float,
                    num_iters: int = 10, _allow_unsound: bool = False):
    """Upper bound on the log marginal likelihood (larger = looser), in
    x's dtype; the inner CG runs in float64 on the float64 Nyström factor.

    ``num_iters`` must stay ≤ 10 (the reference's own inner budget): the
    early stop of the inner minimisation is what makes this an upper bound,
    and more steps raise ``ValueError``. Tighten the bound with more
    inducing points instead. ``_allow_unsound=True`` lifts the guard, for
    the tests that pin the violation.
    """
    if num_iters > 10 and not _allow_unsound:
        raise ValueError(
            f"skc_upper_bound(num_iters={num_iters}): more than 10 inner CG "
            "steps converges the inner quadratic and BREAKS the upper-bound "
            "property (measured violations up to -3019 at sigma^2=1e-6, r4 "
            "adversarial test). Use num_iters <= 10; tighten the bound with "
            "more inducing points, not more inner iterations."
        )
    n = x.shape[0]
    state = nystroem_factor(kernel, x, z, noise, jitter)  # float64
    y = y.to(state.A.dtype)

    def matvec(v):  # (K̂ + σ²I)·v in O(nm)
        return state.A @ (state.A.T @ v) + state.noise * v

    one = torch.ones((), dtype=y.dtype, device=y.device)
    alpha = torch.ones_like(y)
    r = y - matvec(alpha)
    p = r
    for _ in range(num_iters):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        rr = torch.dot(r, r)
        a = rr / torch.where(denom == 0, one, denom)
        alpha = alpha + a * p
        r_new = r - a * Ap
        beta = torch.dot(r_new, r_new) / torch.where(rr == 0, one, rr)
        r, p = r_new, r_new + beta * p
    data_fit_upper = 0.5 * torch.dot(alpha, matvec(alpha)) - torch.dot(alpha, y)
    complexity = -0.5 * nystroem_logdet(state, n)
    return (data_fit_upper + complexity - 0.5 * n * LOG_2PI).to(x.dtype)


def skc_lower_bound(kernel, x, y, z, noise, jitter: float):
    """The Titsias lower bound: the Nyström log likelihood minus
    tr(K − K̂)/(2σ²)."""
    return nystroem_mll(kernel, x, y, z, noise, jitter,
                        titsias_correction=True)
