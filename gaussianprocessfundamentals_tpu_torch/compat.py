"""The reference's (gpbasics') vocabulary over the port: its strategy enums
and the metric factory.

Counterpart of ``gaussianprocessfundamentals_tpu/compat.py``: ``init``
(``:31``), the enums ``MetricType``, ``MatrixApproximations``,
``SubsetOfDataApproaches``, ``NumericalMatrixHandlingType`` and
``FitterType`` (``:40-85``), and ``get_metric`` (``:88``), which maps
(metric, approximation, handling) onto the port's metrics, Nyström, the
SKC bounds and SKI. The port's kernels hold their hyperparameters, so the
returned callables take the kernel where the JAX package's take (kernel,
params): ``fn(kernel, x, y, noise)``; MSE ``fn(kernel, x_train, y_train,
x_test, y_test, noise)``; Nyström, SKC and SKI ``fn(kernel, x, y, z,
noise)`` (z the inducing inputs or SKI's grid). The random subset-of-data
takes ``seed`` (an int or a ``numpy.random.Generator``); the JAX package
always uses seed 0, which is this default.
"""
from __future__ import annotations

import enum
from functools import partial
from typing import Callable

import numpy as np
import torch

from gaussianprocessfundamentals_tpu_torch.config import (
    DEFAULT_CONFIG,
    GPConfig,
)


def init(tf_parallel: int = 0, worker: bool = False, **overrides) -> GPConfig:
    """Source-compatible stand-in for gpbasics' ``global_parameters.init()``:
    the thread-pool and worker arguments are accepted and ignored; returns
    an immutable config with the known ``overrides``."""
    known = set(GPConfig.__dataclass_fields__)
    return GPConfig(**{k: v for k, v in overrides.items() if k in known})


class MetricType(enum.Enum):
    LL = "log_likelihood"
    MSE = "mean_squared_error"
    BIC = "bayesian_information_criterion"


class MatrixApproximations(enum.Enum):
    NONE = "none"
    SKC_LOWER_BOUND = "skc_lower"
    SKC_UPPER_BOUND = "skc_upper"
    BASIC_NYSTROEM = "nystroem"
    SKI = "ski"


class SubsetOfDataApproaches(enum.Enum):
    RANDOM = "random"
    GRID = "grid"
    SMOOTHED_GRID = "smoothed_grid"


class NumericalMatrixHandlingType(enum.Enum):
    """CHOLESKY_BASED is the default; the reference's explicit-inverse
    strategies are solves here as well."""

    STRICT_INVERSE = "strict_inverse"
    PSEUDO_INVERSE = "pseudo_inverse"
    CHOLESKY_BASED = "cholesky"
    LINEAR_CONJUGATE_GRADIENT = "cg"


class FitterType(enum.Enum):
    GRADIENT = "gradient"
    NON_GRADIENT = "non_gradient"


def _subset_idx(n: int, size: int, subset, seed) -> np.ndarray:
    if subset is SubsetOfDataApproaches.RANDOM:
        return np.sort(np.random.default_rng(seed).permutation(n)[:size])
    return np.unique(np.linspace(0, n - 1, size).round().astype(int))


def _nll_cg(config: GPConfig):
    """The LL by CG for the solve and a Cholesky for the log-determinant."""
    from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
    from gaussianprocessfundamentals_tpu_torch.linalg.cg import cg_solve_dense

    def nll_cg(kernel, x, y, noise):
        Kn = chol.noised(kernel.gram(x, x), noise, config.jitter)
        alpha = cg_solve_dense(Kn, y, tol=1e-10, max_iters=4 * x.shape[0])
        L = torch.linalg.cholesky(Kn)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
        return (0.5 * torch.sum(y * alpha) + 0.5 * logdet
                + 0.5 * y.shape[-1] * chol.LOG_2PI)

    return nll_cg


def get_metric(
    metric_type: MetricType,
    approximation: MatrixApproximations = MatrixApproximations.NONE,
    handling: NumericalMatrixHandlingType = (
        NumericalMatrixHandlingType.CHOLESKY_BASED),
    config: GPConfig = DEFAULT_CONFIG,
    subset: SubsetOfDataApproaches = None,
    subset_ratio: float = 0.1,
    blockwise: bool = False,
    seed=0,
) -> Callable:
    """The metric callable for (metric, approximation, handling), as
    gpbasics' ``get_metric_by_type``.

    ``subset`` evaluates the LL or BIC on max(20, ⌊subset_ratio·n⌋) rows:
    RANDOM ones (``seed``), an even GRID, or the SMOOTHED_GRID of
    :meth:`..data.datasets.DataInput.subset_smoothed_grid`.
    ``blockwise=True`` gives the blockwise family for segmented models,
    ``fn(kernel_segments, xs, ys, noise)`` (MSE: train and test segment
    pair lists); it has no approximation."""
    from gaussianprocessfundamentals_tpu_torch.objectives import metrics as M

    if blockwise:
        if approximation is not MatrixApproximations.NONE:
            raise ValueError("blockwise metrics are exact per segment: no "
                             "approximation")
        return {
            MetricType.LL: partial(M.blockwise_neg_log_likelihood,
                                   config=config),
            MetricType.MSE: partial(M.blockwise_mse, config=config),
            MetricType.BIC: partial(M.blockwise_bic, config=config),
        }[metric_type]
    from gaussianprocessfundamentals_tpu_torch.linalg.nystroem import (
        nystroem_nll,
    )
    from gaussianprocessfundamentals_tpu_torch.linalg.ski import ski_mll
    from gaussianprocessfundamentals_tpu_torch.objectives.skc import (
        skc_lower_bound,
        skc_upper_bound,
    )

    def with_subset(fn):
        if subset is None:
            return fn

        def wrapped(kernel, x, y, *a, **k):
            n = x.shape[0]
            size = max(20, int(subset_ratio * n))
            if subset is SubsetOfDataApproaches.SMOOTHED_GRID:
                from gaussianprocessfundamentals_tpu_torch.data import (
                    datasets,
                )

                di = datasets.DataInput(x, y, x, y).subset_smoothed_grid(
                    size)
                return fn(kernel, di.x_train, di.y_train, *a, **k)
            idx = torch.as_tensor(_subset_idx(n, size, subset, seed),
                                  device=x.device)
            return fn(kernel, x[idx], y[idx], *a, **k)

        return wrapped

    if metric_type is MetricType.MSE:
        return partial(M.mean_squared_error, config=config)
    if metric_type is MetricType.BIC:
        return with_subset(partial(M.bic, config=config))
    if approximation is MatrixApproximations.NONE:
        if handling is NumericalMatrixHandlingType.LINEAR_CONJUGATE_GRADIENT:
            return _nll_cg(config)
        return with_subset(partial(M.neg_log_likelihood, config=config))
    jitter = config.jitter
    if approximation is MatrixApproximations.BASIC_NYSTROEM:
        return partial(nystroem_nll, jitter=jitter)
    if approximation is MatrixApproximations.SKC_LOWER_BOUND:
        return lambda *a, **k: -skc_lower_bound(*a, jitter=jitter, **k)
    if approximation is MatrixApproximations.SKC_UPPER_BOUND:
        return lambda *a, **k: -skc_upper_bound(*a, jitter=jitter, **k)
    if approximation is MatrixApproximations.SKI:
        return lambda *a, **k: -ski_mll(*a, jitter=jitter, **k)
    raise ValueError((metric_type, approximation, handling))
