"""Model-selection metrics: NLL, MSE and BIC, their blockwise sums, and
k-fold cross-validation.

Counterpart of ``gaussianprocessfundamentals_tpu/objectives/metrics.py``.
Kernels and means hold their hyperparameters, so the functions take the
modules where the JAX package takes (module, params) pairs; a blockwise
metric takes one kernel per segment. Where the JAX package draws the fold
split from a key, the functions that split take the permutation itself
(``perm``, e.g. ``torch.randperm(n, generator=g)``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gaussianprocessfundamentals_tpu_torch.config import DEFAULT_CONFIG, GPConfig
from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
from gaussianprocessfundamentals_tpu_torch.means.functions import MeanFunction
from gaussianprocessfundamentals_tpu_torch.models.exact import posterior


def _detrend(mean, x, y):
    return y if mean is None else y - mean.mean(x)


def neg_log_likelihood(kernel, x, y, noise, config: GPConfig = DEFAULT_CONFIG,
                       mean: Optional[MeanFunction] = None) -> torch.Tensor:
    """The dense negative log marginal likelihood (differentiable:
    ``kernel.gram`` under autograd)."""
    return chol.nll(kernel.gram(x, x), _detrend(mean, x, y), noise,
                    config.jitter)


def mean_squared_error(kernel, x_train, y_train, x_test, y_test, noise,
                       config: GPConfig = DEFAULT_CONFIG,
                       mean: Optional[MeanFunction] = None) -> torch.Tensor:
    """mean((μ* − y_test)²) of the posterior mean at the test inputs."""
    post = posterior(kernel, x_train, y_train, x_test, noise, config.jitter,
                     mean)
    return torch.mean((post.mean - y_test) ** 2, dim=-1)


def bic(kernel, x, y, noise, config: GPConfig = DEFAULT_CONFIG,
        mean: Optional[MeanFunction] = None) -> torch.Tensor:
    """BIC = −2·LL + |θ|·log n, |θ| the kernel's scalar hyperparameters."""
    nll = neg_log_likelihood(kernel, x, y, noise, config, mean)
    return 2.0 * nll + kernel.num_params() * float(np.log(x.shape[-2]))


def blockwise_neg_log_likelihood(kernel_segments: Sequence, xs, ys, noise,
                                 config: GPConfig = DEFAULT_CONFIG):
    """Σ of the per-segment NLLs over independent blocks."""
    total = 0.0
    for k, x, y in zip(kernel_segments, xs, ys):
        total = total + neg_log_likelihood(k, x, y, noise, config)
    return total


def blockwise_mse(kernel_segments: Sequence, train_segs, test_segs, noise,
                  config: GPConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """The MSE of the per-segment posteriors over all test points."""
    errs = []
    for k, (xtr, ytr), (xte, yte) in zip(kernel_segments, train_segs,
                                         test_segs):
        post = posterior(k, xtr, ytr, xte, noise, config.jitter)
        errs.append((post.mean - yte) ** 2)
    return torch.mean(torch.cat(errs, dim=-1), dim=-1)


def blockwise_bic(kernel_segments: Sequence, xs, ys, noise,
                  config: GPConfig = DEFAULT_CONFIG):
    nll = blockwise_neg_log_likelihood(kernel_segments, xs, ys, noise, config)
    k = sum(ks.num_params() for ks in kernel_segments)
    n = sum(x.shape[-2] for x in xs)
    return 2.0 * nll + k * float(np.log(n))


def kfold_indices(n: int, k: int, perm
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled k-fold split: ``perm``, a permutation of the n rows, cut
    into k folds as ``np.array_split`` cuts; returns (train, test) index
    arrays per fold."""
    folds = np.array_split(np.array(perm), k)
    return [(np.concatenate([folds[j] for j in range(k) if j != i]), folds[i])
            for i in range(k)]


def cross_validate(kernel, x, y, noise, k: int, perm, metric: str = "mse",
                   config: GPConfig = DEFAULT_CONFIG,
                   mean: Optional[MeanFunction] = None) -> torch.Tensor:
    """k-fold CV of fixed hyperparameters: the mean over folds of the
    test-fold MSE (``metric="mse"``) or of the training-fold NLL. The first
    ⌊n/k⌋·k entries of the permutation make k equal folds; fold i trains
    on the folds after it, then those before it, in order."""
    n = x.shape[0]
    m = (n // k) * k
    folds = torch.as_tensor(np.array(perm)[:m].reshape(k, m // k),
                            device=x.device)
    vals = []
    for i in range(k):
        train = torch.roll(folds, -i - 1, dims=0)[:k - 1].reshape(-1)
        test = folds[i]
        if metric == "mse":
            vals.append(mean_squared_error(kernel, x[train], y[train], x[test],
                                           y[test], noise, config, mean))
        else:
            vals.append(neg_log_likelihood(kernel, x[train], y[train], noise,
                                           config, mean))
    return torch.stack(vals).mean(dim=0)


def cross_validate_partitioned(kernel_segments: Sequence, segments, noise,
                               k: int, perms, metric: str = "mse",
                               config: GPConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Partition-aware k-fold CV: folds cut inside each segment (``perms``,
    one permutation per segment), the per-segment CVs weighted by segment
    size."""
    total = sum(int(x.shape[0]) for x, _ in segments)
    acc = 0.0
    for ks, (x, y), perm in zip(kernel_segments, segments, perms):
        w = x.shape[0] / total
        acc = acc + w * cross_validate(ks, x, y, noise, k, perm, metric, config)
    return acc
