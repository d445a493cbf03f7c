"""Fitting with approximation objectives, SciPy's optimisers and batched
independent problems, against the JAX package in float64: the
``make_approx_nll`` objectives with their gradients (inducing inputs
included), ``fit(approximation="nystroem", optimize_inducing=True)``, the
facade's projected-process posterior, ``method="scipy-bfgs"/"scipy-cg"``
and ``fit_batch_independent``. Tolerances are stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.fit import fit as jax_fit_mod
from gaussianprocessfundamentals_tpu_torch.fit import fit as fit_mod
from gaussianprocessfundamentals_tpu_torch.fit.transforms import leaf_copy
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)

NOISE = 1e-2


def _data(n, seed=0, trend=False):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1, (n, 1)), 0)
    y = np.sin(6 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    if trend:
        y = y + 2.0 + 3.0 * x[:, 0]
    return x, y


def _close(got, ref, rtol, what=""):
    """Elementwise relative closeness, and for arrays max|got − ref| ≤
    rtol·max|ref|."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(ref))),
                               err_msg=what)


def _pairs(tree_t, tree_j, path=""):
    """(path, port leaf, JAX leaf) over two trees of the same shape, dict
    keys matched by name (the packages order them differently)."""
    if isinstance(tree_t, dict):
        for k in tree_t:
            yield from _pairs(tree_t[k], tree_j[k], f"{path}/{k}")
    elif isinstance(tree_t, (tuple, list)):
        for i, (a, b) in enumerate(zip(tree_t, tree_j)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, tree_t, tree_j


def _models():
    jk = gpf.SquaredExponentialKernel(scaled=True)
    jm = gpf.ConstantMean()
    return jk, jm, gpt.SquaredExponentialKernel(scaled=True), gpt.ConstantMean()


@pytest.mark.parametrize("approximation,m,noise", [
    ("nystroem", 16, NOISE), ("skc_lower", 16, NOISE),
    ("skc_upper", 16, NOISE), ("ski", 10, 0.1)])
def test_make_approx_nll_matches_jax(approximation, m, noise):
    """Value and gradient of each objective at the default start (ℓ = a
    tenth of the range), with respect to the kernel, mean, noise and (but
    for SKI) inducing inputs, rtol 1e-7.

    The sizes keep the rounding below that: K_mm's condition number grows
    fast with m at this ℓ (at m = 20 the two packages' Cholesky VJPs part
    by 2e-7), and SKI's CG stops at an absolute residual of 1e-6, so its
    adjoint carries ~1e-6/σ² of solver error (σ² = 0.1 here)."""
    x, y = _data(150, seed=1)
    jk, jm, tk, tm = _models()
    inducing = approximation != "ski"
    z = fit_mod.default_inducing(torch.from_numpy(x), m, approximation)
    jz = jax_fit_mod.default_inducing(jnp.asarray(x), m, approximation)
    _close(z, jz, 1e-12, "default_inducing")
    xr = np.stack([x.min(0), x.max(0)], -1)
    ju = jax_fit_mod.init_uparams(jk, jm, jnp.asarray(xr), 150, None,
                                  jnp.float64, True, noise)
    u = fit_mod.init_uparams(tk, tm, xr, 150, None, torch.float64, True, noise)
    if inducing:
        ju["inducing"] = jz
        u["inducing"] = z
    jfn = jax_fit_mod.make_approx_nll(jk, jm, jnp.asarray(x), jnp.asarray(y),
                                      approximation, jz, optimize_noise=True,
                                      optimize_inducing=inducing)
    fn = fit_mod.make_approx_nll(tk, tm, torch.from_numpy(x),
                                 torch.from_numpy(y), approximation, z,
                                 optimize_noise=True,
                                 optimize_inducing=inducing)
    jval, jgrad = jax.jit(jax.value_and_grad(jfn))(ju)
    u = leaf_copy(u)
    val = fn(u)
    val.backward()
    _close(float(val.detach()), float(jval), 1e-7, "value")
    for path, leaf, jleaf in _pairs(u, jgrad):
        _close(leaf.grad, jleaf, 1e-7, f"gradient {path}")


def test_make_approx_nll_refusals():
    x, y = _data(40, seed=2)
    _, _, tk, tm = _models()
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    with pytest.raises(ValueError, match="unknown approximation"):
        fit_mod.make_approx_nll(tk, tm, X, Y, "fitc", X[:5])
    with pytest.raises(ValueError, match="SKI"):
        fit_mod.make_approx_nll(tk, tm, X, Y, "ski", X[:5],
                                optimize_inducing=True)
    with pytest.raises(ValueError, match="kfold"):
        gpt.fit(tk, X, Y, approximation="nystroem", kfold=3,
                generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="SKI"):
        gpt.fit(tk, X, Y, approximation="ski", optimize_inducing=True)


def test_default_inducing_rounds_and_deduplicates():
    """Rounded linspace indices, deduplicated when m is close to n; SKI at
    d = 1 an equispaced grid over x's range; ``fit`` takes m = max(20,
    ⌊config.nystroem_ratio·n⌋) when ``n_inducing`` is not given."""
    x, y = _data(300, seed=3)
    for m, approximation in ((290, "nystroem"), (7, "nystroem"),
                             (400, "ski"), (9, "ski")):
        got = fit_mod.default_inducing(torch.from_numpy(x), m, approximation)
        ref = jax_fit_mod.default_inducing(jnp.asarray(x), m, approximation)
        assert tuple(got.shape) == tuple(ref.shape)
        _close(got, ref, 1e-12, f"{approximation} m={m}")
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    for n, m in ((300, 30), (150, 20)):
        res = gpt.fit(gpt.SquaredExponentialKernel(), X[:n], Y[:n],
                      method="adam", steps=1, approximation="nystroem")
        assert tuple(res.inducing.shape) == (m, 1)


def test_nystroem_fit_with_inducing_matches_jax():
    """``fit(approximation="nystroem", optimize_inducing=True,
    method="adam", steps=20)``: the fitted parameters, noise and inducing
    set within 1e-6 relative of the JAX fit. m = 8: Adam's first steps
    are ±lr by the sign of each gradient entry, and the inducing points
    drift together, so the rounding of an ill-conditioned K_mm grows step
    by step (at m = 12 the two fits' inducing sets part by 7e-5 after 20
    steps, at m = 8 by 1e-10)."""
    x, y = _data(300, seed=4, trend=True)
    kw = dict(method="adam", steps=20, optimize_noise=True, noise=NOISE,
              approximation="nystroem", n_inducing=8, optimize_inducing=True)
    jk, _, tk, _ = _models()
    jres = jax_fit_mod.fit(jk, jnp.asarray(x), jnp.asarray(y),
                           mean=gpf.ConstantMean() + gpf.LinearMean(dim=1), **kw)
    res = gpt.fit(tk, torch.from_numpy(x), torch.from_numpy(y),
                  mean=gpt.ConstantMean() + gpt.LinearMean(dim=1), **kw)
    assert tuple(res.inducing.shape) == (8, 1)
    _close(res.inducing, jres.inducing, 1e-6, "inducing")
    for path, leaf, jleaf in _pairs(res.kernel_params, jres.kernel_params):
        _close(leaf, jleaf, 1e-6, f"kernel {path}")
    for path, leaf, jleaf in _pairs(res.mean_params, jres.mean_params):
        _close(leaf, jleaf, 1e-6, f"mean {path}")
    _close(res.noise, jres.noise, 1e-6, "noise")
    _close(res.history, jres.history, 1e-6, "history")
    _close(res.nll_post, jres.nll_post, 1e-6, "nll_post")
    assert res.nll_post < res.nll_pre


def test_facade_serves_the_projected_process_posterior():
    """After an approximation fit the facade's ``posterior`` is the
    Nyström predictive through the fitted inducing set, the mean added back
    (μ and var within 1e-6 of the JAX facade's); ``full_cov`` still takes
    the exact dense posterior."""
    x, y = _data(200, seed=5, trend=True)
    xt = np.linspace(0.02, 0.98, 30)[:, None]
    kw = dict(method="adam", steps=15, optimize_noise=True, noise=NOISE,
              approximation="nystroem", n_inducing=16, optimize_inducing=True)
    jgp = gpf.GaussianProcess(gpf.SquaredExponentialKernel(scaled=True),
                              gpf.LinearMean(dim=1))
    jgp.fit(jnp.asarray(x), jnp.asarray(y), **kw)
    jpost = jgp.posterior(jnp.asarray(xt))
    gp = gpt.GaussianProcess(gpt.SquaredExponentialKernel(scaled=True),
                             gpt.LinearMean(dim=1), device="cpu")
    res = gp.fit(x, y, **kw)
    assert gp.approximation == "nystroem" and gp.inducing is res.inducing
    post = gp.posterior(xt)
    _close(post.mean, jpost.mean, 1e-6, "mean")
    _close(post.mean_fn_mu, jpost.mean_fn_mu, 1e-6, "mean function")
    _close(post.var, jpost.var, 1e-6, "var")
    assert bool((post.var >= 0).all())
    dense, _ = gp.posterior(xt, full_cov=True)
    jdense, _ = jgp.posterior(jnp.asarray(xt), full_cov=True)
    _close(dense.mean, jdense.mean, 1e-6, "full_cov mean")
    # an exact fit afterwards drops the approximation
    gp.fit(x, y, method="lbfgs", optimize_noise=True)
    assert gp.approximation is None and gp.inducing is None


@pytest.mark.parametrize("method", ["scipy-bfgs", "scipy-cg"])
def test_scipy_fit_matches_jax(method):
    """SciPy's BFGS and nonlinear CG over the flattened tree: final NLL
    within 1e-6 relative of the JAX package's, below the start."""
    x, y = _data(100, seed=6, trend=True)
    kw = dict(method=method, optimize_noise=True, noise=NOISE)
    jres = jax_fit_mod.fit(gpf.SquaredExponentialKernel(scaled=True),
                           jnp.asarray(x), jnp.asarray(y),
                           mean=gpf.ConstantMean() + gpf.LinearMean(dim=1), **kw)
    res = gpt.fit(gpt.SquaredExponentialKernel(scaled=True),
                  torch.from_numpy(x), torch.from_numpy(y),
                  mean=gpt.ConstantMean() + gpt.LinearMean(dim=1), **kw)
    assert res.nll_post < res.nll_pre
    _close(res.nll_post, jres.nll_post, 1e-6, "nll_post")
    _close(res.nll_pre, jres.nll_pre, 1e-9, "nll_pre")


def test_scipy_run_reports_non_finite_values_as_large():
    """A non-finite objective reads (1e30, 0) to SciPy: the line search
    backs off instead of stepping to NaN."""
    u0 = {"a": torch.tensor([0.5], dtype=torch.float64)}
    seen = []

    def nll(u):
        a = u["a"][0]
        out = (a - 0.9) ** 2 - 1e-3 * torch.log(1.0 - a)  # NaN for a > 1
        seen.append(float(out.detach()))
        return out

    u, hist = fit_mod.scipy_run(nll, u0)
    a = float(u["a"][0])
    # the minimum of (a − 0.9)² − 1e-3·log(1 − a)
    assert hist is None and abs(a - (0.95 - np.sqrt(0.0025 + 5e-4))) < 1e-5
    assert not all(np.isfinite(seen))


def test_fit_batch_independent_matches_jax():
    """b = 3 problems, each with its own hyperparameters: per-instance
    kernel parameters, noises and final NLLs within 1e-6 relative."""
    xs, ys = zip(*(_data(60, seed=10 + i) for i in range(3)))
    xb, yb = np.stack(xs), np.stack(ys)
    yb[1] *= 2.0
    kw = dict(steps=40, lr=0.05, optimize_noise=True, noise=NOISE)
    jkp, jnoise, jfinal = jax_fit_mod.fit_batch_independent(
        gpf.SquaredExponentialKernel(scaled=True), jnp.asarray(xb),
        jnp.asarray(yb), **kw)
    kp, noise, final = gpt.fit_batch_independent(
        gpt.SquaredExponentialKernel(scaled=True), torch.from_numpy(xb),
        torch.from_numpy(yb), **kw)
    for path, leaf, jleaf in _pairs(kp, jkp):
        assert tuple(leaf.shape) == (3,)
        _close(leaf, jleaf, 1e-6, path)
    _close(noise, jnoise, 1e-6, "noise")
    _close(final, jfinal, 1e-6, "final NLLs")
    assert len(set(np.round(kp["lengthscale"].numpy(), 6))) == 3
