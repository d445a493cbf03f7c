"""SVGP in the PyTorch port against the JAX package, in float64 on the CPU:
the minibatch ELBO and its gradients, the collapsed bound, the predictive,
a 10-step ``fit_svgp`` fed the JAX function's own inducing rows and
minibatch indices, the zeroed-gradient step, and the ports of
``tests/test_approx.py::test_svgp_fit_learns`` and ``::test_svgp_f32_stable``.
Tolerances are stated per test: XLA's CPU exp/log are float32-accurate in
float64, so values agree to ~1e-10 relative, not 1e-15.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import optax
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.models import svgp as jsvgp
from gaussianprocessfundamentals_tpu_torch.models import svgp as tsvgp
from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)

N, M = 300, 16


def _data(n=N, seed=0, trend=False):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1, (n, 1)), 0)
    y = np.sin(6 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    if trend:
        y = y + 2.0 + 3.0 * x[:, 0]
    return x, y


def _close(got, ref, rtol, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(ref))),
                               err_msg=what)


def _close_norm(got, ref, rtol, what=""):
    """max|got − ref| ≤ rtol·max|ref| over the array."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = float(np.max(np.abs(got - ref)))
    assert err <= rtol * float(np.max(np.abs(ref))), (what, err)


def _params(x, key=jr.PRNGKey(3), seed=1):
    """JAX's init_svgp_params with q(u) moved off its N(0, I) start, so
    every term of the ELBO and its gradient is non-trivial."""
    rng = np.random.default_rng(seed)
    p = jsvgp.init_svgp_params(gpf.SquaredExponentialKernel(scaled=True),
                               jnp.asarray(x), M, key, 1e-2)
    return p._replace(
        q_mu=jnp.asarray(rng.standard_normal(M)),
        q_sqrt=jnp.asarray(np.tril(0.3 * rng.standard_normal((M, M)))
                           + np.eye(M)),
        log_noise=jnp.asarray(np.log(0.03)))


def _means():
    """(JAX mean, its params, port mean with them installed)."""
    jm = gpf.ConstantMean() + gpf.LinearMean(dim=1)
    mp = {"children": ({"c": jnp.asarray(0.4)},
                       {"slope": jnp.asarray([0.7])})}
    tm = gpt.ConstantMean() + gpt.LinearMean(dim=1)
    gpt.params_from_numpy(tm, mp)
    return jm, mp, tm


def _leaf_pairs(tp_grads, jg):
    """(name, port gradient, JAX gradient) per SVGPParams field."""
    k = len(tree_leaves(jg.kernel_u))
    yield from zip(("kernel_u/" + n for n in ("lengthscale", "variance")),
                   tp_grads[:k], (jg.kernel_u["lengthscale"],
                                  jg.kernel_u["variance"]))
    for name, got in zip(("z", "q_mu", "q_sqrt", "log_noise"), tp_grads[k:]):
        yield name, got, getattr(jg, name)


@pytest.mark.parametrize("with_mean", [False, True], ids=["zero", "mean"])
def test_svgp_elbo_and_gradients_match_jax(with_mean):
    """The ELBO on a 100-row minibatch (n_total 300), rtol 1e-8, and its
    gradient with respect to kernel_u, z, q_mu, q_sqrt and log_noise, each
    within 5e-8·max|ref|: the z gradient sums cancelling terms (max|ref|
    ~6e4) and lands 2e-8 of its max apart, the others ≤ 7e-9."""
    x, y = _data(trend=with_mean)
    idx = np.arange(0, N, 3)
    jp = _params(x)
    jk = gpf.SquaredExponentialKernel(scaled=True)
    tk = gpt.SquaredExponentialKernel(scaled=True)
    jm = mp = tm = None
    if with_mean:
        jm, mp, tm = _means()
    xb, yb = jnp.asarray(x[idx]), jnp.asarray(y[idx])
    jval, jg = jax.jit(jax.value_and_grad(
        lambda p: jsvgp.svgp_elbo(jk, p, xb, yb, N, jm, mp)))(jp)
    tp, _ = tsvgp.svgp_adam_init(gpt.svgp_params_from_numpy(tk, jp), 0.0)
    tval = tsvgp.svgp_elbo(tk, tp, torch.from_numpy(x[idx]),
                           torch.from_numpy(y[idx]), N, tm)
    grads = torch.autograd.grad(tval, tsvgp.svgp_leaves(tp))
    _close(float(tval.detach()), float(jval), 1e-8, "elbo")
    for name, got, ref in _leaf_pairs(grads, jg):
        _close_norm(got.numpy(), ref, 5e-8, name)


def test_svgp_predict_and_collapsed_elbo_match_jax():
    """``svgp_predict`` (mean function included) at 50 test points and
    ``collapsed_elbo`` on 12 inducing rows, rtol 1e-8."""
    x, y = _data(trend=True)
    xt = np.linspace(-0.05, 1.05, 50)[:, None]
    jp = _params(x)
    jk = gpf.SquaredExponentialKernel(scaled=True)
    tk = gpt.SquaredExponentialKernel(scaled=True)
    jm, mp, tm = _means()
    jmu, jvar = jax.jit(lambda p, xx: jsvgp.svgp_predict(jk, p, xx, jm, mp))(
        jp, jnp.asarray(xt))
    tmu, tvar = tsvgp.svgp_predict(
        tk, gpt.svgp_params_from_numpy(tk, jp), torch.from_numpy(xt), tm)
    _close(tmu.numpy(), jmu, 1e-8, "mean")
    _close(tvar.numpy(), jvar, 1e-8, "var")

    kp = {"lengthscale": jnp.asarray(0.2), "variance": jnp.asarray(1.3)}
    gpt.params_from_numpy(tk, kp)
    z = x[::25]
    jb = jax.jit(lambda *a: jsvgp.collapsed_elbo(jk, *a, 0.05))(
        kp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    tb = gpt.collapsed_elbo(tk, torch.from_numpy(x), torch.from_numpy(y),
                            torch.from_numpy(z), 0.05)
    _close(float(tb), float(jb), 1e-8, "collapsed elbo")


def _jax_draws(x, key, steps, batch):
    """The inducing rows and minibatch indices JAX's fit_svgp draws
    (``svgp.py:52`` and ``:164``)."""
    n = x.shape[0]
    p0 = jsvgp.init_svgp_params(gpf.SquaredExponentialKernel(scaled=True),
                                jnp.asarray(x), M, jr.fold_in(key, 0), 1e-2)
    keys = jr.split(jr.fold_in(key, 1), steps)
    idx = [torch.from_numpy(np.array(jr.randint(k, (batch,), 0, n)))
           for k in keys]
    return p0, idx


def test_fit_svgp_matches_jax_fed_its_draws():
    """Ten Adam steps (lr 1e-2, batch 64) from JAX's own Z, each on JAX's
    own minibatch: the −ELBO history and the final parameters within rtol
    1e-7 of ``fit_svgp``'s."""
    x, y = _data()
    key, steps, batch = jr.PRNGKey(7), 10, 64
    jparams, jhist = jsvgp.fit_svgp(
        gpf.SquaredExponentialKernel(scaled=True), jnp.asarray(x),
        jnp.asarray(y), m=M, key=key, batch_size=batch, steps=steps)
    p0, idx = _jax_draws(x, key, steps, batch)
    tk = gpt.SquaredExponentialKernel(scaled=True)
    params, opt = tsvgp.svgp_adam_init(gpt.svgp_params_from_numpy(tk, p0),
                                       1e-2)
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    hist = [float(tsvgp.svgp_adam_step(tk, params, opt, X[i], Y[i], N))
            for i in idx]
    _close(hist, jhist, 1e-7, "history")
    for name in ("z", "q_mu", "q_sqrt", "log_noise"):
        _close(getattr(params, name).detach().numpy(),
               getattr(jparams, name), 1e-7, name)
    for name in ("lengthscale", "variance"):
        _close(params.kernel_u[name].detach().numpy(),
               jparams.kernel_u[name], 1e-7, name)


def test_non_finite_step_feeds_adam_a_zeroed_gradient():
    """Two steps, one on a minibatch holding a NaN target, then one more:
    the port's parameters after each step within rtol 1e-8 of optax's Adam
    handed the gradient as JAX's fit_svgp guards it (``svgp.py:170-177``):
    the NaN step is not skipped, it updates the moments and moves the
    parameters on them."""
    x, y = _data()
    jk = gpf.SquaredExponentialKernel(scaled=True)
    tk = gpt.SquaredExponentialKernel(scaled=True)
    jp = _params(x)
    opt = optax.adam(1e-2)
    st = opt.init(jp)
    tp, topt = tsvgp.svgp_adam_init(gpt.svgp_params_from_numpy(tk, jp), 1e-2)
    y_bad = y.copy()
    y_bad[5] = np.nan
    batches = [(np.arange(0, 60), y), (np.arange(0, 60), y_bad),
               (np.arange(60, 120), y)]
    loss_and_grad = jax.jit(jax.value_and_grad(
        lambda p, xb, yb: -jsvgp.svgp_elbo(jk, p, xb, yb, N)))
    for step, (idx, yy) in enumerate(batches):
        loss, g = loss_and_grad(jp, jnp.asarray(x[idx]), jnp.asarray(yy[idx]))
        finite = jnp.isfinite(loss) & jnp.all(jnp.asarray(
            [jnp.all(jnp.isfinite(leaf))
             for leaf in jax.tree_util.tree_leaves(g)]))
        g = jax.tree_util.tree_map(
            lambda leaf: jnp.where(finite, leaf, jnp.zeros_like(leaf)), g)
        upd, st = opt.update(g, st, jp)
        jp = optax.apply_updates(jp, upd)
        tl = tsvgp.svgp_adam_step(tk, tp, topt, torch.from_numpy(x[idx]),
                                  torch.from_numpy(yy[idx]), N)
        assert np.isfinite(float(tl)) == (step != 1)
        for name in ("z", "q_mu", "q_sqrt", "log_noise"):
            _close(getattr(tp, name).detach().numpy(), getattr(jp, name),
                   1e-8, f"step {step}: {name}")
        for name in ("lengthscale", "variance"):
            _close(tp.kernel_u[name].detach().numpy(), jp.kernel_u[name],
                   1e-8, f"step {step}: {name}")


def test_svgp_fit_learns():
    """Port of ``tests/test_approx.py::test_svgp_fit_learns``."""
    x, y = gpf.synth_se(n=400, lengthscale=0.2, noise_sd=0.1, seed=3)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    kernel = gpt.SquaredExponentialKernel(scaled=True)
    params, hist = gpt.fit_svgp(kernel, x, y, m=32, steps=400,
                                batch_size=128,
                                generator=torch.Generator().manual_seed(0))
    assert float(hist[-1]) < float(hist[0])
    fm, fv = gpt.svgp_predict(kernel, params, x)
    assert float(torch.mean((fm - y) ** 2)) < 0.1
    assert bool((fv >= 0).all())


def test_svgp_f32_stable():
    """Port of ``tests/test_approx.py::test_svgp_f32_stable``: float32,
    n = 3,000, m = 64, 400 steps of 2,048 rows, no NaN in the history."""
    rng = np.random.default_rng(0)
    n = 3000
    x = torch.tensor(rng.uniform(0, 1, (n, 1)), dtype=torch.float32)
    y = torch.tensor(np.sin(12 * x.numpy()[:, 0])
                     + 0.1 * rng.standard_normal(n), dtype=torch.float32)
    kernel = gpt.SquaredExponentialKernel(scaled=True)
    params, hist = gpt.fit_svgp(kernel, x, y, m=64, steps=400,
                                batch_size=2048,
                                generator=torch.Generator().manual_seed(0))
    assert int(torch.isnan(hist).sum()) == 0
    assert float(hist[-1]) < float(hist[0])
    fm, _ = gpt.svgp_predict(kernel, params, x)
    assert float(torch.mean((fm - y) ** 2)) < 0.1 * float(torch.var(y))
