"""Segmented GPs against the JAX package (the metrics and k-fold:
``tests/test_torch_metrics.py``).

Float64 unless stated: ``pad_segments`` exactly, ``segmented_nll`` against
the sum of per-segment NLLs and against the JAX package to 1e-8; the
float32 effective-jitter case of ``tests/test_models.py:79-99`` to 2e-5;
``BlockwiseGP`` and ``PartitionedGP`` posteriors and log marginal
likelihoods at the same installed parameters to 1e-8 (the posterior is
held at equal parameters, not the fits); ``fit_segments_vmapped`` over 20
Adam steps from the deterministic start to 1e-5 of optax's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.kernels.partition import (
    DistancePartitioning as JDist,
)
from gaussianprocessfundamentals_tpu.models import segmented as jseg
from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
from gaussianprocessfundamentals_tpu_torch.models import segmented as tseg
from gaussianprocessfundamentals_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
)
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


def test_pad_segments_and_segmented_nll():
    segs = [_seg(25, 1), _seg(18, 2), _seg(31, 3)]
    xb, yb, mb = tseg.pad_segments([_t(x) for x, _ in segs],
                                   [_t(y) for _, y in segs])
    jx, jy, jm = jseg.pad_segments([jnp.asarray(x) for x, _ in segs],
                                   [jnp.asarray(y) for _, y in segs])
    for got, ref in ((xb, jx), (yb, jy), (mb, jm)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    k = _se(gpt)
    stacked = {"lengthscale": _t([0.2, 0.3, 0.15]),
               "variance": _t([1.3, 0.7, 2.0])}
    noise = _t([0.1, 0.05, 0.2])  # one noise per segment
    total = float(tseg.segmented_nll([k], stacked, xb, yb, mb, noise, 1e-8))
    expected = 0.0
    for s, (x, y) in enumerate(segs):
        k.set_params({n: v[s] for n, v in stacked.items()})
        expected += float(chol.nll(k.gram(_t(x), _t(x)), _t(y), noise[s], 1e-8))
    np.testing.assert_allclose(total, expected, rtol=1e-8)
    # the JAX package's takes one shared noise
    jk, _ = _se(gpf)
    jtotal = float(jseg.segmented_nll(
        [jk], {n: jnp.asarray(v.numpy()) for n, v in stacked.items()},
        jx, jy, jm, 0.1, 1e-8))
    total = float(tseg.segmented_nll([k], stacked, xb, yb, mb, 0.1, 1e-8))
    np.testing.assert_allclose(total, jtotal, rtol=1e-8)


def test_masked_nll_f32_effective_jitter_exact():
    """In float32 the factorisation floors the jitter (the eps floor binds
    over the raw 1e-8) and the padded rows' correction must use that same
    effective value, with a scaled kernel so the pad diagonal matters."""
    x, y = gpf.synth_se(n=64, seed=0)
    x = torch.from_numpy(np.asarray(x, np.float32))
    y = torch.from_numpy(np.asarray(y, np.float32))
    k = gpt.SquaredExponentialKernel(scaled=True).set_params(
        {"lengthscale": torch.tensor(0.2), "variance": torch.tensor(3.0)})
    noise, jitter, pad = 0.05, 1e-8, 30
    exact = float(chol.nll(k.gram(x, x), y, noise, jitter))
    xp = torch.cat([x, x[:1].expand(pad, -1)])
    yp = torch.cat([y, torch.zeros(pad)])
    mask = torch.cat([torch.ones(64), torch.zeros(pad)])
    padded = float(tseg.masked_nll(k.gram(xp, xp), yp, mask, noise, jitter))
    np.testing.assert_allclose(padded, exact, rtol=2e-5)


def _install(tgp, jgp, xs, ys, params, noise):
    """The same segment data and parameters in a port GP and a JAX GP."""
    tgp.set_data(_t(xs), _t(ys))
    gpt.params_from_numpy(tgp.kernel, params, dtype=torch.float64)
    tgp.noise = noise
    jgp.set_data(jnp.asarray(xs), jnp.asarray(ys))
    jgp.kernel_params = jax.tree_util.tree_map(jnp.asarray, params)
    jgp.noise = jnp.asarray(noise)


def _check_models(tm, jm, x, y, xt, params, noises):
    for tgp, jgp, (xs, ys), p, nz in zip(tm.gps, jm.gps,
                                         jm._segment(jnp.asarray(x),
                                                     jnp.asarray(y)),
                                         params, noises):
        _install(tgp, jgp, np.asarray(xs), np.asarray(ys), p, nz)
    got = tm.predict(_t(xt))
    ref = jm.predict(jnp.asarray(xt))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-8,
                                   atol=1e-10)
    np.testing.assert_allclose(tm.log_marginal_likelihood(),
                               jm.log_marginal_likelihood(), rtol=1e-8)


def test_blockwise_gp_matches_jax_at_equal_parameters():
    """Half-open segments [lo, hi) on x[:, 0], test points on the
    boundaries included, SE and Matérn-5/2 alternating; a kernel object
    passed for two segments is copied for the second."""
    x = np.concatenate([_seg(26, 4, 0.0, 0.4)[0], _seg(24, 5, 0.4, 0.7)[0],
                        _seg(25, 6, 0.7, 1.0)[0]])
    x[5, 0] = 0.4  # into the second segment: 25 rows each, one JAX compile
    y = np.sin(9 * x[:, 0])
    xt = np.linspace(0.0, 1.0, 21)[:, None]
    m52 = gpt.Matern52Kernel(scaled=True)
    tm = gpt.BlockwiseGP([gpt.SquaredExponentialKernel(scaled=True), m52, m52],
                         locations=[0.4, 0.7], device="cpu")
    assert tm.kernels[1] is m52 and tm.kernels[2] is not m52
    jm = gpf.BlockwiseGP([gpf.SquaredExponentialKernel(scaled=True),
                          gpf.Matern52Kernel(scaled=True),
                          gpf.Matern52Kernel(scaled=True)], locations=[0.4, 0.7])
    params = [{"lengthscale": 0.15, "variance": 1.1},
              {"lengthscale": 0.3, "variance": 0.6},
              {"lengthscale": 0.08, "variance": 2.0}]
    _check_models(tm, jm, x, y, xt, params, [0.01, 0.03, 0.02])


def test_partitioned_gp_matches_jax_at_equal_parameters():
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (70, 2))
    y = np.where(x[:, 0] < 0.5, -1.0, 1.0) + np.sin(5 * x[:, 1])
    xt = rng.uniform(0, 1, (17, 2))
    centers = ((0.25, 0.5), (0.75, 0.5))
    tm = gpt.PartitionedGP(
        [gpt.SquaredExponentialKernel(dim=2, scaled=True),
         gpt.SquaredExponentialKernel(dim=2)],
        model=gpt.DistancePartitioning(centers=centers),
        mean=gpt.ConstantMean(dim=2), device="cpu")
    jm = gpf.PartitionedGP(
        [gpf.SquaredExponentialKernel(dim=2, scaled=True),
         gpf.SquaredExponentialKernel(dim=2)],
        model=JDist(centers=centers), mean=gpf.ConstantMean(dim=2))
    assert tm.gps[0].mean is not tm.gps[1].mean
    for tgp, jgp, c in zip(tm.gps, jm.gps, (0.3, -0.2)):
        tgp.mean.set_params({"c": torch.tensor(c, dtype=torch.float64)})
        jgp.mean_params = {"c": jnp.asarray(c)}
    params = [{"lengthscale": np.array([0.3, 0.2]), "variance": 0.9},
              {"lengthscale": 0.25}]
    _check_models(tm, jm, x, y, xt, params, [0.02, 0.05])


def test_fit_segments_vmapped_matches_optax():
    """20 Adam steps from the deterministic start (key None): final NLLs
    within 1e-5 of the JAX package's vmapped optax Adam, the fitted
    parameters read back through ``stacked_params_from_numpy``."""
    segs = [_seg(30, 8, 0.0, 0.5), _seg(22, 9, 0.5, 1.0)]
    jk, _ = _se(gpf)
    jkp, jnoise, jfinal = jseg.fit_segments_vmapped(
        jk, [(jnp.asarray(x), jnp.asarray(y)) for x, y in segs], steps=20)
    tk = gpt.SquaredExponentialKernel(scaled=True)
    kp, noise, final = gpt.fit_segments_vmapped(
        tk, [(_t(x), _t(y)) for x, y in segs], steps=20)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), rtol=1e-5)
    ref = gpt.stacked_params_from_numpy(tk, jax.tree_util.tree_map(
        np.asarray, jkp), dtype=torch.float64)
    for n in ("lengthscale", "variance"):
        assert kp[n].shape == (2,)
        np.testing.assert_allclose(kp[n].numpy(), ref[n].numpy(), rtol=1e-5)
    np.testing.assert_allclose(noise.numpy(), np.asarray(jnoise), rtol=1e-5)


@pytest.mark.parametrize("name", ["SE~s", "PER", "RQ", "composite",
                                  "changepoint", "SE-ard"])
def test_stacked_gram_equals_the_per_slice_grams(name):
    """``stacked_gram`` (one ``torch.func.vmap`` over the slices) against
    each slice's ``gram`` with its own parameters installed, float64, and
    its gradient against the per-slice sum's; the kernel's installed
    parameters come back."""
    kernel, d = {
        "SE~s": (gpt.SquaredExponentialKernel(scaled=True), 1),
        "PER": (gpt.PeriodicKernel(), 1),
        "RQ": (gpt.RationalQuadraticKernel(), 1),
        "composite": (gpt.SquaredExponentialKernel(scaled=True)
                      * gpt.PeriodicKernel() + gpt.LinearKernel()
                      + gpt.WhiteNoiseKernel(scaled=True), 1),
        "changepoint": (gpt.ChangePoint(children=(
            gpt.SquaredExponentialKernel(), gpt.Matern52Kernel())), 1),
        "SE-ard": (gpt.SquaredExponentialKernel(dim=2), 2),
    }[name]
    g = torch.Generator().manual_seed(4)
    x = torch.rand(3, 40, d, generator=g, dtype=torch.float64)
    slices = [kernel.init_params([[0.0, 1.0]] * d, 40,
                                 torch.Generator().manual_seed(i),
                                 torch.float64) for i in range(3)]
    params = tree_map(lambda *l: torch.stack(l).requires_grad_(True),
                      *slices)
    kernel.set_params(slices[0])
    got = tseg.stacked_gram(kernel, params, x)
    assert all(tree_leaves(tree_map(torch.equal, kernel.get_params(),
                                    slices[0])))
    # a ChangePoint's hard gate has no gradient in its steepness
    grads = torch.autograd.grad(got.sum(), tree_leaves(params),
                                allow_unused=True, materialize_grads=True)
    for i in range(3):
        pi = tree_map(lambda t: t[i].detach().requires_grad_(True), params)
        ref = kernel.set_params(pi).gram(x[i], x[i])
        np.testing.assert_allclose(got[i].detach().numpy(),
                                   ref.detach().numpy(), rtol=1e-13,
                                   atol=1e-15)
        for a, b in zip(grads, torch.autograd.grad(
                ref.sum(), tree_leaves(pi), allow_unused=True,
                materialize_grads=True)):
            np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=1e-10,
                                       atol=1e-12)
