"""The port's fitting slice against the JAX package, in float64: the dense
NLL and its gradient, the SLQ log-determinant, the iterative NLL + gradient
pieces on the JAX package's own probes, Adam and L-BFGS, the iterative Adam
loop with its step guard, and the whole slice through the facade with
checkpoints read by the other package.

Tolerances are stated per test. XLA's CPU ``exp``/``log`` are
float32-accurate even in float64, so values that go through many of them
agree to ~1e-8 relative, not to round-off.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.fit import fit as jax_fit_mod
from gaussianprocessfundamentals_tpu.linalg import cholesky as jax_chol
from gaussianprocessfundamentals_tpu.linalg.mbcg import mbcg as jax_mbcg
from gaussianprocessfundamentals_tpu.linalg.mbcg import slq_logdet_host
from gaussianprocessfundamentals_tpu.models import iterative as jax_iterative
from gaussianprocessfundamentals_tpu.utils import checkpoint as jax_checkpoint
from gaussianprocessfundamentals_tpu_torch.config import GPConfig
from gaussianprocessfundamentals_tpu_torch.fit import fit as fit_mod
from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
from gaussianprocessfundamentals_tpu_torch.linalg.mbcg import slq_logdet
from gaussianprocessfundamentals_tpu_torch.models import iterative
from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves

# The suite runs one pytest-xdist worker per core: torch's own thread pool
# on top of that oversubscribes the CPU and slows every worker.
torch.set_num_threads(1)

NOISE = 1e-2


def _data(n, seed=0, trend=False):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1, (n, 1)), 0)
    y = np.sin(8 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    if trend:
        y = y + 2.0 + 3.0 * x[:, 0]
    return x, y


def _se(ls=0.12, var=1.3):
    jk = gpf.SquaredExponentialKernel(scaled=True)
    jp = {"lengthscale": jnp.asarray(ls), "variance": jnp.asarray(var)}
    tk = gpt.kernel_from_dict(jk.to_dict())
    gpt.params_from_numpy(tk, {k: np.asarray(v) for k, v in jp.items()})
    return jk, jp, tk


def _mean_pair(c=0.4, slope=2.5):
    jm = gpf.ConstantMean() + gpf.LinearMean(dim=1)
    jmp = {"children": ({"c": jnp.asarray(c)},
                        {"slope": jnp.asarray([slope])})}
    tm = gpt.mean_from_dict(jm.to_dict())
    gpt.params_from_numpy(tm, {"['children']/[0]/['c']": np.asarray(c),
                               "['children']/[1]/['slope']": np.asarray([slope])})
    return jm, jmp, tm


def _close(got, ref, rtol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               err_msg=what)


def test_dense_nll_and_gradient_match_jax():
    """The closed-form backward of ``_MLLCore`` against ``jax.grad`` through
    the JAX package's custom VJP, for the kernel's parameters, the noise and
    y (rtol 1e-7)."""
    x, y = _data(120, seed=1)
    jk, jp, tk = _se()

    def jax_nll(p, noise, yy):
        return jax_chol.nll(jk.gram(p, jnp.asarray(x), jnp.asarray(x)), yy,
                            noise, 1e-8)

    ref, (gp_ref, gn_ref, gy_ref) = jax.value_and_grad(jax_nll, (0, 1, 2))(
        jp, jnp.asarray(NOISE), jnp.asarray(y))
    xt = torch.from_numpy(x)
    noise = torch.tensor(NOISE, dtype=torch.float64, requires_grad=True)
    yt = torch.from_numpy(y).requires_grad_(True)
    with tk.differentiable() as p:
        out = chol.nll(tk.gram(xt, xt), yt, noise, 1e-8)
        grads = torch.autograd.grad(out, [p["lengthscale"], p["variance"],
                                          noise, yt])
    _close(float(out.detach()), float(ref), 1e-7, "nll")
    _close(grads[0], gp_ref["lengthscale"], 1e-7, "lengthscale")
    _close(grads[1], gp_ref["variance"], 1e-7, "variance")
    _close(grads[2], gn_ref, 1e-7, "noise")
    _close(grads[3], gy_ref, 1e-7, "y")


def test_dense_mll_is_nan_when_the_factorisation_fails():
    K = torch.ones(4, 4, dtype=torch.float64)
    K[0, 1] = K[1, 0] = 2.0
    assert torch.isnan(chol.mll(K, torch.ones(4, dtype=torch.float64), 0.0, 0.0))


def test_slq_logdet_matches_host_form():
    """One batched float64 ``eigh`` against the JAX package's host loop on
    the same CG coefficients, with a column that converged early (α = 0
    tail) and one whose coefficients went non-finite (rtol 1e-10)."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((60, 60))
    A = A @ A.T / 60 + 0.5 * np.eye(60)
    B = rng.standard_normal((60, 4))
    B[:, 1] = np.linalg.eigh(A)[1][:, 0]  # an eigenvector: done in one step
    res = jax_mbcg(lambda V: jnp.asarray(A) @ V, jnp.asarray(B), max_iters=20,
                   tol=1e-9, early_exit=False)
    al = np.asarray(res.alphas).copy()
    be = np.asarray(res.betas).copy()
    assert (al[5:, 1] == 0).all()
    al[7, 3] = np.inf
    zw = np.sum(B * B, axis=0)
    ref = slq_logdet_host(al, be, zw, 60)
    got = slq_logdet(*map(torch.from_numpy, (al, be, zw)))
    assert got.dtype == torch.float64 and np.isfinite(float(got))
    _close(float(got), ref, 1e-10)


def _jax_probes(key, n, s, m):
    """The (u, w) draws of the JAX package's ``_core_impl``
    (``iterative.py:284-304``)."""
    key_u, key_w = jr.split(key)
    if m == 0:
        return np.array(jr.rademacher(key_u, (n, s)).astype(jnp.float64)), None
    return (np.array(jr.normal(key_u, (n, s), jnp.float64)),
            np.array(jr.normal(key_w, (m, s), jnp.float64)))


def _port_w(jk, jp, tk, x, m, w):
    """The w that makes the port's probes z = σu + W_b·diag(sv)·w equal the
    JAX package's: the preconditioner bases of the two packages span the
    same space but differ in column signs and order, so w is expressed in
    the port's basis, w' = diag(1/sv)·W_bᵀ·W_jax·diag(sv_jax)·w."""
    _, Wj, svj, _, _ = jax_iterative.build_preconditioner(
        jk, jp, jnp.asarray(x), m, NOISE)
    _, Wp, svp, _, _ = iterative.build_preconditioner(
        tk, torch.from_numpy(x), m, NOISE)
    a = Wp.numpy().T @ (np.asarray(Wj) @ (np.asarray(svj)[:, None] * w))
    svp = svp.numpy()[:, None]
    return np.where(svp > 0, a / np.where(svp > 0, svp, 1.0), 0.0)


@pytest.mark.parametrize("materialize", [True, False])
@pytest.mark.parametrize("with_mean", [False, True])
def test_iterative_nll_and_grad_match_jax(monkeypatch, materialize, with_mean):
    """``iterative_nll_and_grad`` on the JAX package's own probes: the NLL,
    every gradient, the per-column residuals and the CG coefficients agree
    to rtol 1e-6 (the preconditioner's QR and SVD differ between the
    packages; everything downstream is the same arithmetic). Five CG
    iterations at a tolerance no column reaches, so neither package freezes
    a column at a borderline residual."""
    n, s, m = 300, 4, 4
    x, y = _data(n, seed=3, trend=with_mean)
    jk, jp, tk = _se(ls=0.03)
    jm = jmp = tm = None
    if with_mean:
        jm, jmp, tm = _mean_pair()
    key = jr.PRNGKey(7)
    kw = dict(max_iters=5, tol=1e-14, precond_m=m, early_exit=False,
              materialize=materialize)
    ref = jax_iterative._core_impl(
        jk, jp, jnp.asarray(x), jnp.asarray(y), NOISE, key, num_probes=s,
        block=128, mean=jm, mean_params=jmp, **kw)
    ref_nll = jax_iterative.iterative_nll_and_grad(
        jk, jp, jnp.asarray(x), jnp.asarray(y), NOISE, key, num_probes=s,
        block=128, mean=jm, mean_params=jmp, **kw)[0]
    u, w = _jax_probes(key, n, s, m)
    w = _port_w(jk, jp, tk, x, m, w)
    got = iterative._core_impl(tk, torch.from_numpy(x), torch.from_numpy(y),
                               NOISE, torch.from_numpy(u), torch.from_numpy(w),
                               mean=tm, **kw)
    names = ("data_fit", "log_P", "alphas", "betas", "z_weights")
    for name, g, r in zip(names, got[:5], ref[:5]):
        _close(g, r, 1e-6, name)
    for p in ("lengthscale", "variance"):
        _close(got[5][p], ref[5][p], 1e-6, p)
    _close(got[6], ref[6], 1e-6, "grad_noise")
    _close(got[8], ref[8], 1e-6, "resid")
    if with_mean:
        for g, r in zip(tree_leaves(got[7]), jax.tree_util.tree_leaves(ref[7])):
            _close(g, r, 1e-6, "grad_mean")
    monkeypatch.setattr(iterative, "draw_probes", lambda *a: (
        torch.from_numpy(u), torch.from_numpy(w)))
    out = iterative.iterative_nll_and_grad(
        tk, torch.from_numpy(x), torch.from_numpy(y), NOISE, num_probes=s,
        mean=tm, **kw)
    assert len(out) == (5 if with_mean else 4)
    _close(float(out[0]), float(ref_nll), 1e-6, "nll")


def test_fit_iterative_matches_jax_step_for_step(monkeypatch):
    """Ten Adam steps of ``fit_iterative`` with a mean, the median-residual
    guard and bounds, each step on the probes the JAX package draws for it
    (``jr.fold_in(key, i)`` on its step-at-a-time route, Rademacher without a
    preconditioner): histories, final parameters and the skipped-step share
    agree to rtol 1e-6."""
    n, s, steps = 200, 4, 10
    x, y = _data(n, seed=4, trend=True)
    key = jr.PRNGKey(3)
    kw = dict(steps=steps, lr=0.1, num_probes=s, max_iters=40, tol=1e-8,
              precond_m=0, early_exit=False, resid_guard=0.5,
              enforce_bounds=True, init_noise=0.05)
    jkp, jmp, jnoise, jhist, jdiag = jax_iterative.fit_iterative(
        gpf.SquaredExponentialKernel(scaled=True), jnp.asarray(x),
        jnp.asarray(y), key, mean=gpf.ConstantMean() + gpf.LinearMean(dim=1),
        callback=lambda i, v: None, return_diagnostics=True, block=128, **kw)
    draws = iter(_jax_probes(jr.fold_in(key, i), n, s, 0)[0]
                 for i in range(steps))
    monkeypatch.setattr(iterative, "draw_probes", lambda *a: (
        torch.from_numpy(next(draws)), None))
    kernel = gpt.SquaredExponentialKernel(scaled=True)
    mean = gpt.ConstantMean() + gpt.LinearMean(dim=1)
    kp, mp, noise, hist, diag = iterative.fit_iterative(
        kernel, torch.from_numpy(x), torch.from_numpy(y), mean=mean,
        return_diagnostics=True, **kw)
    _close(hist, jhist, 1e-6, "history")
    _close(noise, jnoise, 1e-6, "noise")
    for p in ("lengthscale", "variance"):
        _close(kp[p], jkp[p], 1e-6, p)
        # the fitted values are installed in the module
        assert float(getattr(kernel, p)) == float(kp[p])
    for g, r in zip(tree_leaves(mp), jax.tree_util.tree_leaves(jmp)):
        _close(g, r, 1e-6, "mean")
    assert diag == pytest.approx(jdiag)


def test_step_guard_freezes_every_step():
    """A residual guard no solve can meet skips every step: the fit returns
    its initial point and says so (``frozen_frac`` 1)."""
    x, y = _data(150, seed=5)
    kernel = gpt.SquaredExponentialKernel(scaled=True)
    kp, noise, hist, diag = iterative.fit_iterative(
        kernel, torch.from_numpy(x), torch.from_numpy(y), steps=3,
        max_iters=3, precond_m=8, resid_guard=1e-12, init_noise=0.05,
        return_diagnostics=True, generator=torch.Generator().manual_seed(0))
    init = kernel.init_params(np.array([[x.min(), x.max()]]), 150,
                              dtype=torch.float64)
    assert diag == {"frozen_frac": 1.0}
    for p in init:
        _close(kp[p], init[p], 1e-12, p)
    _close(noise, 0.05, 1e-12)
    assert torch.isfinite(hist).all()


def _jax_nll_setup(x, y, optimize_noise=True):
    jk, jm = gpf.SquaredExponentialKernel(scaled=True), gpf.ConstantMean()
    xr = jnp.stack([jnp.asarray(x).min(0), jnp.asarray(x).max(0)], -1)
    nll = jax_fit_mod.make_nll(jk, jm, jnp.asarray(x), jnp.asarray(y),
                               optimize_noise=optimize_noise)
    u0 = jax_fit_mod.init_uparams(jk, jm, xr, x.shape[0], None, jnp.float64,
                                  optimize_noise, NOISE)
    return nll, u0


def test_adam_run_matches_optax_history():
    """``torch.optim.Adam`` and ``optax.adam`` follow one update rule: 30
    steps on the dense NLL give the same history and end point (rtol
    1e-6)."""
    x, y = _data(100, seed=6, trend=True)
    jnll, ju0 = _jax_nll_setup(x, y)
    ju, jhist = jax_fit_mod.adam_run(jnll, ju0, steps=30, lr=0.05)
    kernel, mean = gpt.SquaredExponentialKernel(scaled=True), gpt.ConstantMean()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    xr = np.array([[x.min(), x.max()]])
    nll = fit_mod.make_nll(kernel, mean, xt, yt, optimize_noise=True)
    u0 = fit_mod.init_uparams(kernel, mean, xr, 100, None, torch.float64,
                              True, NOISE)
    u, hist = fit_mod.adam_run(nll, u0, steps=30, lr=0.05)
    assert hist.shape == (30,)
    _close(hist, jhist, 1e-6, "history")
    _close(u["log_noise"], ju["log_noise"], 1e-6, "log_noise")
    _close(u["kernel"]["lengthscale"], ju["kernel"]["lengthscale"], 1e-6)
    _close(u["mean"]["c"], ju["mean"]["c"], 1e-6)


def test_lbfgs_fit_reaches_the_jax_optimum():
    """L-BFGS takes another path (strong-Wolfe here, zoom there) to the same
    optimum: final NLLs within 1e-6 relative."""
    x, y = _data(120, seed=7, trend=True)
    jres = jax_fit_mod.fit(gpf.SquaredExponentialKernel(scaled=True),
                           jnp.asarray(x), jnp.asarray(y),
                           mean=gpf.ConstantMean() + gpf.LinearMean(dim=1),
                           method="lbfgs", optimize_noise=True, noise=NOISE)
    res = gpt.fit(gpt.SquaredExponentialKernel(scaled=True),
                  torch.from_numpy(x), torch.from_numpy(y),
                  mean=gpt.ConstantMean() + gpt.LinearMean(dim=1),
                  method="lbfgs", optimize_noise=True, noise=NOISE)
    assert res.nll_post < res.nll_pre
    _close(res.nll_post, jres.nll_post, 1e-6, "nll_post")
    _close(res.nll_pre, jres.nll_pre, 1e-9, "nll_pre")


def test_fit_routing_and_what_is_not_ported():
    x, y = _data(64, seed=8)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    k = gpt.SquaredExponentialKernel()
    # ported: SciPy's BFGS, an approximation objective (its inducing set
    # in the result), optimize_inducing (a no-op without an approximation,
    # as in the JAX package)
    for kw in ({"method": "scipy-bfgs"}, {"approximation": "nystroem"},
               {"optimize_inducing": True}):
        res = gpt.fit(k, xt, yt, **kw)
        assert np.isfinite(res.nll_post) and res.nll_post <= res.nll_pre
        assert (res.inducing is not None) == ("approximation" in kw)
    # the k-fold objective is ported; its fold split needs a generator
    with pytest.raises(ValueError, match="generator"):
        gpt.fit(k, xt, yt, kfold=3)
    # batched input fits one shared parameter set; its k-fold split is not
    # defined (the JAX package fails on the shapes)
    res = gpt.fit(k, torch.stack([xt, xt]), torch.stack([yt, -yt]))
    assert np.isfinite(res.nll_post) and res.nll_post <= res.nll_pre
    with pytest.raises(ValueError, match="one instance"):
        gpt.fit(k, xt[None], yt[None], kfold=3,
                generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="method"):
        gpt.fit(k, xt, yt, method="newton")
    # a dense set over the budget goes to the iterative route, with a warning
    tiny = GPConfig(dense_hbm_budget=1e3)
    with pytest.warns(UserWarning, match="iterative"):
        res = gpt.fit(k, xt, yt, config=tiny, method="adam", steps=2,
                      optimize_noise=True,
                      iterative_kwargs={"precond_m": 8, "max_iters": 10})
    assert res.diagnostics is not None and res.history.shape == (2,)
    # ... unless a fixed noise below 1e-6 keeps it off that route
    with pytest.raises(ValueError, match="dense_hbm_budget"):
        gpt.fit(k, xt, yt, config=tiny, noise=1e-8)


def test_jitter_escalation_recovers_a_failed_factorisation(monkeypatch):
    """A dense NLL that comes out non-finite is retried with the jitter ×10:
    the first attempt's factorisation is made to fail."""
    x, y = _data(40, seed=9)
    jitters = []
    real_nll = chol.nll

    def failing_nll(K, resid, noise, jitter):
        jitters.append(jitter)
        out = real_nll(K, resid, noise, jitter)
        return out * float("nan") if jitter < 1e-7 else out

    monkeypatch.setattr(chol, "nll", failing_nll)
    res = gpt.fit(gpt.SquaredExponentialKernel(), torch.from_numpy(x),
                  torch.from_numpy(y), noise=NOISE,
                  config=GPConfig(jitter=1e-8))
    assert np.isfinite(res.nll_post)
    assert min(jitters) == 1e-8 and max(jitters) == pytest.approx(1e-7)


def test_mean_functions_match_jax():
    jm, jmp, tm = _mean_pair()
    assert tm.to_dict() == jm.to_dict()
    assert isinstance(gpt.ConstantMean() + gpt.LinearMean() + gpt.ZeroMean(),
                      gpt.MeanSum)
    assert len((gpt.ConstantMean() + gpt.LinearMean() + gpt.ZeroMean()).terms) == 3
    x = np.random.default_rng(10).uniform(0, 1, (7, 1))
    _close(tm.mean(torch.from_numpy(x)), jm.mean(jmp, jnp.asarray(x)), 1e-14)
    assert tm.positivity() == jm.positivity()
    # unbounded: fit's bounds projection clips kernel hyperparameters only
    inf = float("inf")
    assert tm.bounds() == ({"children": ({"c": -inf}, {"slope": -inf})},
                           {"children": ({"c": inf}, {"slope": inf})})
    init = tm.init_params(dtype=torch.float64)
    jinit = jm.init_params(dtype=jnp.float64)
    for g, r in zip(tree_leaves(init), jax.tree_util.tree_leaves(jinit)):
        _close(g, r, 1e-14)


@pytest.mark.parametrize("route", ["dense", "auto-iterative", "iterative"])
def test_facade_fit_then_checkpoints_both_ways(tmp_path, route):
    """The whole slice on the CPU: the port's facade fits (the dense L-BFGS
    route, the iterative Adam route that ``method="auto"`` takes when the
    dense working set is over budget, and ``method="iterative"``), serves a
    posterior, and saves; the JAX package loads that checkpoint and predicts
    the same (rtol 1e-8); a JAX save of it loads back in the port to the
    same predictions."""
    x, y = _data(240, seed=11, trend=True)
    xt = np.linspace(0, 1, 25)[:, None]
    gp = gpt.GaussianProcess(gpt.SquaredExponentialKernel(scaled=True),
                             gpt.ConstantMean() + gpt.LinearMean(dim=1),
                             device="cpu")
    ikw = {"precond_m": 16, "max_iters": 30, "tol": 1e-6}
    if route == "dense":
        res = gp.fit(x, y, method="auto", optimize_noise=True, noise=NOISE)
        assert res.diagnostics is None
    elif route == "auto-iterative":
        gp.config = GPConfig(dense_hbm_budget=1e3)
        res = gp.fit(x, y, method="auto", optimize_noise=True, noise=NOISE,
                     steps=8, lr=0.05, iterative_kwargs=ikw)
        assert res.diagnostics == {"frozen_frac": 0.0}
    else:
        res = gp.fit(x, y, method="iterative", steps=8, lr=0.05,
                     init_noise=NOISE, generator=torch.Generator().manual_seed(1),
                     **ikw)
        assert res.history.shape == (8,)
    assert res.nll_post < res.nll_pre
    assert float(gp.noise) == float(res.noise)
    post = gp.posterior(xt)
    assert torch.isfinite(post.mean).all() and (post.var >= 0).all()
    assert np.isfinite(float(gp.log_marginal_likelihood()))

    path = str(tmp_path / "gp")
    gpt.save(path, gp.kernel, gp.mean, gp.noise)
    jk, jkp, jm, jmp, jnoise = jax_checkpoint.load(path)
    jgp = gpf.GaussianProcess(jk, jm, kernel_params=jkp, mean_params=jmp,
                              noise=jnp.asarray(jnoise))
    jgp.set_data(jnp.asarray(x), jnp.asarray(y))
    jpost = jgp.posterior(jnp.asarray(xt))
    _close(post.mean, jpost.mean, 1e-8, "mean")
    np.testing.assert_allclose(post.var.numpy(), np.asarray(jpost.var),
                               rtol=0, atol=1e-8 * float(gp.kernel.variance))

    back = str(tmp_path / "back")
    jax_checkpoint.save(back, jk, jkp, mean=jm, mean_params=jmp, noise=jnoise)
    kernel, mean, noise = gpt.load(back)
    gp2 = gpt.GaussianProcess(kernel, mean, noise=noise, device="cpu")
    post2 = gp2.set_data(x, y).posterior(xt)
    torch.testing.assert_close(post2.mean, post.mean, rtol=1e-12, atol=0)
    torch.testing.assert_close(post2.var, post.var, rtol=1e-12, atol=1e-15)


def test_jax_params_tree_to_the_port():
    """``tree_from_numpy`` takes the JAX package's nested params of a
    ``MeanSum`` as it holds them, or flat checkpoint paths."""
    _, jmp, tm = _mean_pair(c=0.7, slope=-1.5)
    nested = gpt.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jmp))
    assert float(nested["children"][0]["c"]) == 0.7
    assert nested["children"][1]["slope"].tolist() == [-1.5]
    tm.set_params(nested)
    assert float(tm.terms[0].c) == 0.7


def test_facade_defaults_to_the_card():
    gp = gpt.GaussianProcess(gpt.SquaredExponentialKernel())
    assert gp.device.type == "cuda"


def _mauna_data(n, seed=42):
    """A Mauna-Loa-shaped series (trend + two seasonal harmonics + noise,
    the JAX package's ``synth_mauna_loa`` formula), x and y min-max
    normalised to [0, 1]."""
    t = np.linspace(1958.0, 2018.0, n)
    y = (315.0 + 0.8 * (t - 1958.0) + 0.012 * (t - 1958.0) ** 2
         + 3.0 * np.sin(2 * np.pi * t) + 0.8 * np.sin(4 * np.pi * t)
         + 0.3 * np.random.default_rng(seed).standard_normal(n))
    return ((t - t.min()) / (t.max() - t.min()))[:, None], (y - y.min()) / (
        y.max() - y.min())


def _mauna_pair():
    """The Mauna Loa composite SE~s·PER + SE~s + LIN + WN~s in both
    packages, with the same hyperparameters."""
    jk = (gpf.SquaredExponentialKernel(scaled=True) * gpf.PeriodicKernel()
          + gpf.SquaredExponentialKernel(scaled=True) + gpf.LinearKernel()
          + gpf.WhiteNoiseKernel(scaled=True))
    jp = {"children": (
        {"children": ({"lengthscale": jnp.asarray(0.3), "variance": jnp.asarray(0.05)},
                      {"lengthscale": jnp.asarray(0.8), "period": jnp.asarray(0.05)})},
        {"lengthscale": jnp.asarray(0.15), "variance": jnp.asarray(0.2)},
        {"offset": jnp.asarray([0.4])},
        {"variance": jnp.asarray(0.02)})}
    tk = gpt.kernel_from_dict(jk.to_dict())
    gpt.params_from_numpy(tk, jax.tree_util.tree_map(np.asarray, jp))
    return jk, jp, tk


@pytest.mark.parametrize("materialize", [True, False])
def test_composite_core_impl_matches_jax(materialize):
    """The composite slice's NLL + gradient core on the JAX package's own
    probes: the Mauna Loa composite (root WhiteNoise included) on the
    materialised and the streamed routes, every gradient leaf to rtol 1e-6
    (the SE case's tolerance: the same arithmetic downstream of the
    preconditioner)."""
    n, s, m = 500, 4, 8
    x, y = _mauna_data(n)
    jk, jp, tk = _mauna_pair()
    key = jr.PRNGKey(5)
    kw = dict(max_iters=6, tol=1e-14, precond_m=m, early_exit=False,
              materialize=materialize)
    ref = jax_iterative._core_impl(jk, jp, jnp.asarray(x), jnp.asarray(y),
                                   NOISE, key, num_probes=s, block=128, **kw)
    u, w = _jax_probes(key, n, s, m)
    w = _port_w(jk, jp, tk, x, m, w)
    got = iterative._core_impl(tk, torch.from_numpy(x), torch.from_numpy(y),
                               NOISE, torch.from_numpy(u), torch.from_numpy(w),
                               **kw)
    for name, g, r in zip(("data_fit", "log_P", "alphas", "betas",
                           "z_weights"), got[:5], ref[:5]):
        _close(g, r, 1e-6, name)
    assert len(tree_leaves(got[5])) == 8
    for path, r in _paths(ref[5]):
        _close(_at(got[5], path), r, 1e-6, str(path))
    _close(got[6], ref[6], 1e-6, "grad_noise")
    _close(got[8], ref[8], 1e-6, "resid")


def _paths(tree, path=()):
    """(path, leaf) pairs of a params tree: the JAX package orders dict
    leaves by key, the port by parameter, so leaves are matched by path."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in _paths(v, path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [pl for i, v in enumerate(tree) for pl in _paths(v, path + (i,))]
    return [(path, tree)]


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def test_composite_facade_fit_posterior_and_checkpoints_both_ways(tmp_path):
    """The composite slice through the facade on the CPU: ``fit(method=
    "auto")`` on the iterative Adam route (the dense set made over budget),
    a posterior, and a checkpoint of the fitted composite saved by each
    package and loaded by the other, predicting the same (rtol 1e-8)."""
    x, y = _mauna_data(400)
    xt = (np.arange(30)[:, None] + 0.5) / 30.0
    kernel = (gpt.SquaredExponentialKernel(scaled=True) * gpt.PeriodicKernel()
              + gpt.SquaredExponentialKernel(scaled=True) + gpt.LinearKernel()
              + gpt.WhiteNoiseKernel(scaled=True))
    gp = gpt.GaussianProcess(kernel, device="cpu",
                             config=GPConfig(dense_hbm_budget=1e3))
    res = gp.fit(x, y, method="auto", optimize_noise=True, noise=NOISE,
                 steps=6, lr=0.05, iterative_kwargs={"precond_m": 16,
                                                     "max_iters": 30,
                                                     "tol": 1e-6})
    assert res.diagnostics == {"frozen_frac": 0.0}
    assert res.nll_post < res.nll_pre
    post = gp.posterior(xt)
    assert torch.isfinite(post.mean).all() and (post.var >= 0).all()

    path = str(tmp_path / "mauna")
    gpt.save(path, gp.kernel, None, gp.noise)
    jk, jkp, _, _, jnoise = jax_checkpoint.load(path)
    assert jk.to_dict() == gp.kernel.to_dict()
    jgp = gpf.GaussianProcess(jk, kernel_params=jkp, noise=jnp.asarray(jnoise))
    jgp.set_data(jnp.asarray(x), jnp.asarray(y))
    jpost = jgp.posterior(jnp.asarray(xt))
    _close(post.mean, jpost.mean, 1e-8, "mean")
    np.testing.assert_allclose(post.var.numpy(), np.asarray(jpost.var),
                               rtol=0, atol=1e-8)

    back = str(tmp_path / "back")
    jax_checkpoint.save(back, jk, jkp, noise=jnoise)
    kernel2, _, noise2 = gpt.load(back)
    post2 = gpt.GaussianProcess(kernel2, noise=noise2, device="cpu").set_data(
        x, y).posterior(xt)
    torch.testing.assert_close(post2.mean, post.mean, rtol=1e-12, atol=0)
    torch.testing.assert_close(post2.var, post.var, rtol=1e-12, atol=1e-15)


def test_lbfgs_backtracks_from_a_non_finite_nll():
    """A trial point whose NLL is not finite (a Cholesky that failed) must
    make the line search backtrack. torch's strong-Wolfe search reads a NaN
    loss as no failed decrease test and extrapolates: on one H100 a dense
    segment fit of the port ran off to infinite hyperparameters that way.
    Here the objective decreases up to a wall at x = 2 behind which it is
    NaN; the fit must end finite, just before the wall."""
    def nll(u):
        x = u["x"]
        return torch.where(x < 2.0, (x - 1.95) ** 2 - 0.5 * x,
                           torch.full_like(x, float("nan")))

    for x0 in (0.0, -3.0):
        x = torch.tensor(x0, dtype=torch.float64)
        u, _ = fit_mod.lbfgs_run(nll, {"x": x}, max_iters=50)
        assert 1.99 < float(u["x"]) < 2.0
        assert float(nll(u)) < -0.99
