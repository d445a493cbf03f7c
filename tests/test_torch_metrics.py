"""The metrics, cross-validation and the k-fold objective, against the JAX
package.

Float64: NLL, MSE and BIC and their blockwise sums to 1e-8; the fold split,
cross-validation (plain and partition-aware) and the k-fold objective on
the JAX package's fold permutations to 1e-8; a k-fold fit lowers its NLL.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.fit.fit import (
    init_uparams as jax_init_uparams,
)
from gaussianprocessfundamentals_tpu.fit.fit import (
    make_kfold_nll as jax_make_kfold_nll,
)
from gaussianprocessfundamentals_tpu.objectives import metrics as jmet
from gaussianprocessfundamentals_tpu_torch.objectives import metrics as tmet
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)


def _seg(n, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(lo, hi, (n, 1)), axis=0)
    y = np.sin(9 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    return x, y


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _se(pkg, ls=0.2, var=1.3):
    k = pkg.SquaredExponentialKernel(scaled=True)
    p = {"lengthscale": ls, "variance": var}
    if pkg is gpt:
        return k.set_params({n: torch.tensor(v, dtype=torch.float64)
                             for n, v in p.items()})
    return k, {n: jnp.asarray(v) for n, v in p.items()}


# every dense solve below is 30 training rows against 10 test rows, as
# each fold of the 4-fold CVs, so the JAX package compiles each step once


def test_metrics_match_jax():
    x, y = _seg(30, 10)
    xt, yt = _seg(10, 11)
    tk = _se(gpt)
    jk, jp = _se(gpf)
    tmean = gpt.LinearMean().set_params({"slope": _t([0.4])})
    jmp = {"slope": jnp.asarray([0.4])}
    pairs = [
        (tmet.neg_log_likelihood(tk, _t(x), _t(y), 0.05, mean=tmean),
         jmet.neg_log_likelihood(jk, jp, jnp.asarray(x), jnp.asarray(y), 0.05,
                                 mean=gpf.LinearMean(), mean_params=jmp)),
        (tmet.mean_squared_error(tk, _t(x), _t(y), _t(xt), _t(yt), 0.05),
         jmet.mean_squared_error(jk, jp, jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(xt), jnp.asarray(yt), 0.05)),
        (tmet.bic(tk, _t(x), _t(y), 0.05),
         jmet.bic(jk, jp, jnp.asarray(x), jnp.asarray(y), 0.05)),
    ]
    segs = [(x, y), _seg(30, 15)]
    tks = [_se(gpt, 0.2), _se(gpt, 0.1, 0.5)]
    jks, jps = zip(_se(gpf, 0.2), _se(gpf, 0.1, 0.5))
    pairs += [
        (tmet.blockwise_neg_log_likelihood(tks, [_t(a) for a, _ in segs],
                                           [_t(b) for _, b in segs], 0.05),
         jmet.blockwise_neg_log_likelihood(jks, jps,
                                           [jnp.asarray(a) for a, _ in segs],
                                           [jnp.asarray(b) for _, b in segs],
                                           0.05)),
        (tmet.blockwise_mse(tks, [(_t(a), _t(b)) for a, b in segs],
                            [(_t(xt), _t(yt))] * 2, 0.05),
         jmet.blockwise_mse(jks, jps,
                            [(jnp.asarray(a), jnp.asarray(b)) for a, b in segs],
                            [(jnp.asarray(xt), jnp.asarray(yt))] * 2, 0.05)),
        (tmet.blockwise_bic(tks, [_t(a) for a, _ in segs],
                            [_t(b) for _, b in segs], 0.05),
         jmet.blockwise_bic(jks, jps, [jnp.asarray(a) for a, _ in segs],
                            [jnp.asarray(b) for _, b in segs], 0.05)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-8)


@pytest.mark.parametrize("metric", ["mse", "nll"])
def test_cross_validation_on_shared_folds(metric):
    x, y = _seg(43, 12)
    key = jr.PRNGKey(5)
    perm = np.asarray(jr.permutation(key, 43))
    for (tr, te), (jtr, jte) in zip(tmet.kfold_indices(43, 4, perm),
                                    jmet.kfold_indices(43, 4, key)):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(te, jte)
    tk = _se(gpt)
    jk, jp = _se(gpf)
    got = tmet.cross_validate(tk, _t(x), _t(y), 0.05, 4, perm, metric=metric)
    ref = jmet.cross_validate(jk, jp, jnp.asarray(x), jnp.asarray(y), 0.05, 4,
                              key, metric=metric)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-8)
    segs = [(x[:40], y[:40]), _seg(40, 14)]
    perms = [np.asarray(jr.permutation(jr.fold_in(key, i), len(s[0])))
             for i, s in enumerate(segs)]
    got = tmet.cross_validate_partitioned(
        [tk, _se(gpt, 0.1)], [(_t(a), _t(b)) for a, b in segs], 0.05, 4,
        perms, metric=metric)
    ref = jmet.cross_validate_partitioned(
        [jk, _se(gpf, 0.1)[0]], [jp, _se(gpf, 0.1)[1]],
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in segs], 0.05, 4, key,
        metric=metric)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-8)


def test_kfold_objective_and_fit():
    x, y = _seg(36, 13)
    key = jr.PRNGKey(2)
    jk = gpf.SquaredExponentialKernel(scaled=True)
    u = jax_init_uparams(jk, gpf.ZeroMean(), [[0.0, 1.0]], 36,
                         dtype=jnp.float64, optimize_noise=True,
                         init_noise=0.03)
    ref = float(jax_make_kfold_nll(jk, gpf.ZeroMean(), jnp.asarray(x),
                                   jnp.asarray(y), 3, key,
                                   optimize_noise=True)(u))
    tk = gpt.SquaredExponentialKernel(scaled=True)
    tu = jax.tree_util.tree_map(lambda v: torch.tensor(np.asarray(v)), u)
    got = float(gpt.make_kfold_nll(tk, gpt.ZeroMean(), _t(x), _t(y), 3,
                                   np.asarray(jr.permutation(key, 36)),
                                   optimize_noise=True)(tu))
    np.testing.assert_allclose(got, ref, rtol=1e-8)
    res = gpt.fit(tk, _t(x), _t(y), kfold=3, optimize_noise=True,
                  generator=torch.Generator().manual_seed(0))
    assert np.isfinite(res.nll_post) and res.nll_post < res.nll_pre
