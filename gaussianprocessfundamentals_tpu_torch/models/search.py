"""Greedy compositional kernel search (CKS-style) over the kernel grammar.

Counterpart of ``gaussianprocessfundamentals_tpu/models/search.py``:
``SearchResult`` (``:37``), ``default_base_kernels`` (``:45``), ``_bic_of``
(``:54-56``) and ``greedy_kernel_search`` (``:59-116``), after Duvenaud et
al. (2013): fit every base kernel, then repeatedly expand the best
expression with best + b and best · b for each base b, fit each candidate
and keep the best by BIC (the parameter count plus the noise).

The port's kernels are modules that hold their hyperparameters, and ``fit``
installs the fitted ones. Every candidate is therefore built from deep
copies of its parts, so no fit changes another candidate's parameters, the
best kernel's, or the caller's base kernels.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gaussianprocessfundamentals_tpu_torch.config import DEFAULT_CONFIG, GPConfig
from gaussianprocessfundamentals_tpu_torch.fit.fit import fit
from gaussianprocessfundamentals_tpu_torch.kernels.leaves import (
    LinearKernel,
    Matern52Kernel,
    PeriodicKernel,
    SquaredExponentialKernel,
)


@dataclasses.dataclass
class SearchResult:
    kernel: Any  # the best expression, its fitted hyperparameters installed
    params: Any
    noise: Any
    score: float
    history: List[Tuple[str, float]]  # (str(candidate), BIC) in fit order


def default_base_kernels():
    return (
        SquaredExponentialKernel(scaled=True),
        PeriodicKernel(scaled=True),
        LinearKernel(),
        Matern52Kernel(scaled=True),
    )


def _bic_of(res, kernel, n: int) -> float:
    k = kernel.num_params() + 1  # + noise
    return float(2.0 * res.nll_post + k * np.log(n))


def _generator(seed: int, i: int) -> torch.Generator:
    """The generator of candidate i (on the host, where the restarts'
    starting points are drawn): seeded from (seed, i), where the JAX
    package folds i into its key."""
    state = np.random.SeedSequence([seed, i]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def greedy_kernel_search(
    x: torch.Tensor,
    y: torch.Tensor,
    base_kernels: Optional[Sequence] = None,
    max_depth: int = 2,
    seed: int = 0,
    config: GPConfig = DEFAULT_CONFIG,
    fit_kwargs: Optional[dict] = None,
    verbose: bool = False,
) -> SearchResult:
    """Greedy BIC-guided search; returns the best expression found.

    ``max_depth`` counts expansion rounds: depth 0 evaluates the base
    kernels, each further round tries best + b and best · b for every base
    b (skipping expressions equal up to argument order, by
    ``canonical_str``), and the search stops after a round that does not
    improve the score by 1e-6. Each candidate's fit (``fit_kwargs`` over
    Adam, 200 steps, lr 0.05, optimised noise) takes a generator seeded
    from ``seed`` and the candidate's number (i for the bases,
    1000·depth + j in round ``depth``), which draws its restarts."""
    base_kernels = base_kernels or default_base_kernels()
    fk = dict(method="adam", steps=200, lr=0.05, optimize_noise=True)
    fk.update(fit_kwargs or {})
    n = x.shape[0]
    history: List[Tuple[str, float]] = []

    def evaluate(kernel, i):
        res = fit(kernel, x, y, config=config,
                  generator=_generator(seed, i), **fk)
        score = _bic_of(res, kernel, n)
        history.append((str(kernel), score))
        if verbose:
            print(f"  {score:10.1f}  {kernel}")
        return res, score

    seen = set()
    best = None
    for i, b in enumerate(base_kernels):
        seen.add(b.canonical_str())
        cand = copy.deepcopy(b).to(x.device)
        res, score = evaluate(cand, i)
        if best is None or score < best[3]:
            best = (cand, res.kernel_params, res.noise, score)

    for depth in range(1, max_depth + 1):
        improved = False
        current = best[0]
        for j, b in enumerate(base_kernels):
            for op in ("+", "*"):
                left = copy.deepcopy(current)
                right = copy.deepcopy(b).to(x.device)
                cand = left + right if op == "+" else left * right
                # canonical-form dedup: skip candidates equal up to the
                # order of Sum/Product arguments
                cs = cand.canonical_str()
                if cs in seen:
                    continue
                seen.add(cs)
                res, score = evaluate(cand, 1000 * depth + j)
                if score < best[3] - 1e-6:
                    best = (cand, res.kernel_params, res.noise, score)
                    improved = True
        if not improved:
            break

    return SearchResult(best[0], best[1], best[2], best[3], history)
