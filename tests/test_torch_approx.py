"""The approximation slice against the JAX package, in float64: CG and its
implicit gradient, the Nyström factor with its Woodbury solve,
determinant-lemma log-det, log likelihood and projected-process posterior,
the SKC bounds, and SKI's interpolation, Toeplitz product and log
likelihoods. The same numpy-seeded inputs go through both packages.

Tolerances are stated per test: 1e-9 relative where both packages do the
same dense algebra, 1e-6 where a CG solve with an absolute tolerance stops
on either side of a threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.linalg import cg as jax_cg
from gaussianprocessfundamentals_tpu.linalg import nystroem as jax_ny
from gaussianprocessfundamentals_tpu.linalg import ski as jax_ski
from gaussianprocessfundamentals_tpu.objectives import skc as jax_skc
from gaussianprocessfundamentals_tpu_torch.linalg import cg
from gaussianprocessfundamentals_tpu_torch.linalg import nystroem as ny
from gaussianprocessfundamentals_tpu_torch.linalg import ski
from gaussianprocessfundamentals_tpu_torch.objectives import skc
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)

JITTER = 1e-8


def _data(n, seed=0, d=1):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1, (n, d)), 0)
    y = np.sin(8 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    return x, y


def _se(ls=0.15, var=1.3):
    jk = gpf.SquaredExponentialKernel(scaled=True)
    jp = {"lengthscale": jnp.asarray(ls), "variance": jnp.asarray(var)}
    tk = gpt.SquaredExponentialKernel(scaled=True).set_params({
        "lengthscale": torch.tensor(ls, dtype=torch.float64),
        "variance": torch.tensor(var, dtype=torch.float64)})
    return jk, jp, tk


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a, np.float64)) for a in arrays]


def _close(got, ref, rtol, what=""):
    """Elementwise relative closeness, and for arrays max|got − ref| ≤
    rtol·max|ref| (entries that cancel to near 0 carry the absolute error
    of the large ones)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(ref))),
                               err_msg=what)


def _jax_nystroem(jk):
    """The JAX side of the Nyström test as one jitted program (the noise an
    argument: one compile for both cases)."""
    @jax.jit
    def ref(jp, x, y, z, xt, B, noise):
        st = jax_ny.nystroem_factor(jk, jp, x, z, noise, JITTER)
        return {"solve_y": jax_ny.woodbury_solve(st, y),
                "solve_B": jax_ny.woodbury_solve(st, B),
                "logdet": jax_ny.nystroem_logdet(st, 300),
                "mll": [jax_ny.nystroem_mll(jk, jp, x, y, z, noise, JITTER,
                                            titsias_correction=t)
                        for t in (False, True)],
                "posterior": jax_ny.nystroem_posterior(jk, jp, x, y, z, xt,
                                                       noise, JITTER)}
    return ref


@pytest.mark.parametrize("noise", [1e-2, 0.1])
def test_nystroem_solve_logdet_mll_and_posterior_match_jax(noise):
    """``woodbury_solve`` ([n] and [n, k]), ``nystroem_logdet``,
    ``nystroem_mll`` with and without the Titsias correction, and
    ``nystroem_posterior``, rtol 1e-9."""
    x, y = _data(300, seed=1)
    z = x[::12][:25]
    xt = np.linspace(0, 1, 40)[:, None]
    B = np.random.default_rng(2).standard_normal((300, 3))
    jk, jp, tk = _se()
    X, Y, Z, XT, BT = _t(x, y, z, xt, B)
    ref = _jax_nystroem(jk)(jp, *map(jnp.asarray, (x, y, z, xt, B)), noise)
    st = ny.nystroem_factor(tk, X, Z, noise, JITTER)
    for bt, r in ((Y, ref["solve_y"]), (BT, ref["solve_B"])):
        _close(ny.woodbury_solve(st, bt), r, 1e-9, "woodbury_solve")
    _close(ny.nystroem_logdet(st, 300), ref["logdet"], 1e-9, "logdet")
    for titsias in (False, True):
        _close(ny.nystroem_mll(tk, X, Y, Z, noise, JITTER,
                               titsias_correction=titsias),
               ref["mll"][titsias], 1e-9, f"mll titsias={titsias}")
    mu, var = ny.nystroem_posterior(tk, X, Y, Z, XT, noise, JITTER)
    jmu, jvar = ref["posterior"]
    _close(mu, jmu, 1e-9, "posterior mean")
    _close(var, jvar, 1e-9, "posterior variance")
    assert gpt.ops.cuda_dense_gram.se_gram.launches == 0  # CPU: plain Grams


def test_nystroem_mll_titsias_uses_diag_fn():
    """``diag_fn`` replaces ``kernel.diag`` in the trace term."""
    x, y = _data(80, seed=3)
    _, _, tk = _se()
    X, Y, Z = _t(x, y, x[::8])
    base = ny.nystroem_mll(tk, X, Y, Z, 0.1, JITTER, titsias_correction=True)
    shifted = ny.nystroem_mll(tk, X, Y, Z, 0.1, JITTER,
                              titsias_correction=True,
                              diag_fn=lambda xx: tk.diag(xx) + 1.0)
    _close(base - shifted, 80 / (2 * 0.1), 1e-9)


@pytest.mark.parametrize("m,num_iters", [(10, 3), (25, 10), (50, 10)])
def test_skc_bounds_match_jax(m, num_iters):
    """``skc_lower_bound`` and ``skc_upper_bound`` on the JAX package's
    sandwich problem (``tests/test_block_cholesky.py``: σ² = 0.1; at
    σ² = 1e-2 the tenth unconverged CG step amplifies round-off past
    1e-9 in both packages), rtol 1e-9, and their gradients in ℓ, rtol
    1e-6."""
    x, y = _data(120, seed=0)
    z = x[:: len(x) // m][:m]
    jk, jp, tk = _se(0.2, 1.0)
    X, Y, Z = _t(x, y, z)
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), 0.1, JITTER)
    with tk.differentiable() as p:
        lo = skc.skc_lower_bound(tk, X, Y, Z, 0.1, JITTER)
        up = skc.skc_upper_bound(tk, X, Y, Z, 0.1, JITTER, num_iters=num_iters)
        g_lo = torch.autograd.grad(lo, p["lengthscale"])[0]
        g_up = torch.autograd.grad(up, p["lengthscale"])[0]
    (j_lo, jg_lo), (j_up, jg_up) = jax.jit(lambda ls: (
        jax.value_and_grad(lambda ls: jax_skc.skc_lower_bound(
            jk, {**jp, "lengthscale": ls}, *args))(ls),
        jax.value_and_grad(lambda ls: jax_skc.skc_upper_bound(
            jk, {**jp, "lengthscale": ls}, *args,
            num_iters=num_iters))(ls)))(jp["lengthscale"])
    _close(lo.detach(), j_lo, 1e-9, "lower")
    _close(up.detach(), j_up, 1e-9, "upper")
    # differentiating the Cholesky of K_mm (κ ~ 1e8 at ℓ = 0.2, m ≥ 25):
    # torch's and JAX's VJP formulas round differently
    _close(g_lo, jg_lo, 1e-6, "lower gradient")
    _close(g_up, jg_up, 1e-6, "upper gradient")
    assert float(lo.detach()) < float(up.detach())


def test_skc_upper_bound_refuses_more_than_ten_inner_steps():
    x, y = _data(60, seed=4)
    _, _, tk = _se()
    X, Y, Z = _t(x, y, x[::6])
    with pytest.raises(ValueError, match="num_iters"):
        skc.skc_upper_bound(tk, X, Y, Z, 0.1, JITTER, num_iters=11)
    out = skc.skc_upper_bound(tk, X, Y, Z, 0.1, JITTER, num_iters=11,
                              _allow_unsound=True)
    assert np.isfinite(float(out))


@pytest.mark.parametrize("d,m", [(1, 30), (2, 15)])
def test_ski_interp_matches_jax(d, m):
    """d = 1: the ``searchsorted`` path on a sorted grid; d = 2: the
    two-nearest-neighbour path. Indices equal, weights within 1e-12."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (200, d))
    grid = (np.linspace(0, 1, m)[:, None] if d == 1
            else rng.uniform(0, 1, (m, d)))
    X, G = _t(x, grid)
    idx, w = ski.ski_interp(X, G)
    jidx, jw = jax_ski.ski_interp(jnp.asarray(x), jnp.asarray(grid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-12)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-12)


def test_ski_interp_knn_tie_order_and_matvec():
    """Tied distances come in index order (``lax.top_k``'s), and
    ``ski_matvec`` is W K_mm Wᵀv + σ²v with the dense W."""
    x = np.array([[0.5, 0.5], [0.1, 0.9], [0.25, 0.5]])
    grid = np.array([[0.0, 0.5], [1.0, 0.5], [0.5, 0.0], [0.5, 1.0]])
    X, G = _t(x, grid)
    idx, _ = ski.ski_interp(X, G)
    jidx, _ = jax_ski.ski_interp(jnp.asarray(x), jnp.asarray(grid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0].tolist() == [0, 1]  # four-way tie: the lowest indices
    _, _, tk = _se(0.4, 1.0)
    st = ski.ski_factor(tk, X, G)
    W = np.zeros((3, 4))
    for i in range(3):
        for j in range(2):
            W[i, st.idx[i, j]] += float(st.w[i, j])
    v = np.random.default_rng(6).standard_normal(3)
    dense = W @ st.K_mm.numpy() @ W.T + 0.2 * np.eye(3)
    np.testing.assert_allclose(ski.ski_matvec(st, 0.2, _t(v)[0]).numpy(),
                               dense @ v, rtol=1e-12)


def test_toeplitz_matvec_matches_jax():
    grid = np.linspace(0, 1, 50)[:, None]
    jk, jp, tk = _se(0.2, 1.0)
    col = tk.gram(*_t(grid, grid[:1]))[:, 0]
    V = np.random.default_rng(7).standard_normal((50, 3))
    jcol = jk.gram(jp, jnp.asarray(grid), jnp.asarray(grid[:1]))[:, 0]
    for v in (V, V[:, 0]):
        got = ski.toeplitz_matvec(col, _t(v)[0])
        _close(got, jax_ski.toeplitz_matvec(jcol, jnp.asarray(v)), 1e-9)
        _close(got, tk.gram(*_t(grid, grid)).numpy() @ v, 1e-9)


@pytest.mark.parametrize("toeplitz", [False, True])
def test_ski_mll_matches_jax(toeplitz):
    """``ski_mll`` and ``ski_mll_toeplitz``: value and gradient in the
    kernel's parameters, the noise and y, through the implicit CG, rtol
    1e-6."""
    x, y = _data(300, seed=8)
    grid = np.linspace(x.min(), x.max(), 30)[:, None]
    jk, jp, tk = _se(0.2, 1.1)
    X, Y, G = _t(x, y, grid)
    fn = ski.ski_mll_toeplitz if toeplitz else ski.ski_mll
    jfn = jax_ski.ski_mll_toeplitz if toeplitz else jax_ski.ski_mll
    noise = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    Yg = Y.clone().requires_grad_(True)
    stats = {}
    with tk.differentiable() as p:
        val = fn(tk, X, Yg, G, noise, JITTER, stats=stats)
        grads = torch.autograd.grad(
            val, [p["lengthscale"], p["variance"], noise, Yg])
    jval, jgrads = jax.jit(jax.value_and_grad(
        lambda pp, nz, yy: jfn(jk, pp, jnp.asarray(x), yy, jnp.asarray(grid),
                               nz, JITTER), argnums=(0, 1, 2)))(
        jp, jnp.asarray(0.05), jnp.asarray(y))
    _close(val.detach(), jval, 1e-6, "value")
    _close(grads[0], jgrads[0]["lengthscale"], 1e-6, "d/d lengthscale")
    _close(grads[1], jgrads[0]["variance"], 1e-6, "d/d variance")
    _close(grads[2], jgrads[1], 1e-6, "d/d noise")
    _close(grads[3], jgrads[2], 1e-6, "d/d y")
    assert len(stats["iters"]) == 2 and all(0 < i < 1200 for i in stats["iters"])


def _spd_operator(seed=9, n=40):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1, (n, 1)), 0)
    b = rng.standard_normal(n)
    w = rng.standard_normal(n)
    return x, b, w


def test_cg_solve_implicit_gradient_matches_jax():
    """The implicit backward against ``lax.custom_linear_solve``'s: the
    gradient of Σw·A(θ)⁻¹b with respect to b and to θ = (ℓ, σ_f², s) of
    A = K(θ) + s·I, rtol 1e-6 (CG to max|r| < 1e-10 on both sides)."""
    x, b, w = _spd_operator()
    jk, jp, tk = _se(0.3, 1.2)

    def jloss(pp, s, bb):
        K = jk.gram(pp, jnp.asarray(x), jnp.asarray(x))
        sol = jax_cg.cg_solve_implicit(lambda v: K @ v + s * v, bb,
                                       tol=1e-10, max_iters=400)
        return jnp.sum(jnp.asarray(w) * sol)

    jval, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        jp, jnp.asarray(0.05), jnp.asarray(b))
    X, Bt, Wt = _t(x, b, w)
    s = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    Bt.requires_grad_(True)
    with tk.differentiable() as p:
        K = tk.gram(X, X)
        sol = cg.cg_solve_implicit(lambda v, KK, ss: KK @ v + ss * v, Bt,
                                   (K, s), tol=1e-10, max_iters=400)
        val = torch.sum(Wt * sol)
        g = torch.autograd.grad(val, [p["lengthscale"], p["variance"], s, Bt])
    _close(val.detach(), jval, 1e-9, "value")
    _close(g[0], jg[0]["lengthscale"], 1e-6, "d/d lengthscale")
    _close(g[1], jg[0]["variance"], 1e-6, "d/d variance")
    _close(g[2], jg[1], 1e-6, "d/d s")
    _close(g[3], jg[2], 1e-6, "d/d b")


@pytest.mark.parametrize("tol,max_iters", [(1e-2, None), (1e-8, 7),
                                           (1e-6, 500)])
def test_cg_solve_returns_the_jax_iterate(tol, max_iters):
    """The device-frozen loop returns the iterate of the JAX while_loop:
    stopped by the absolute test or by the cap (7, not a multiple of the
    host-read interval); ``cg_solve_dense`` too. (κ = 28: on a worse
    conditioned system the iterates just past convergence carry round-off
    that differs between the two packages' products.)"""
    x, b, _ = _spd_operator(seed=10, n=60)
    jk, jp, tk = _se(0.2, 1.0)
    K = np.asarray(jk.gram(jp, jnp.asarray(x), jnp.asarray(x))) + np.eye(60)
    ref = jax_cg.cg_solve_dense(jnp.asarray(K), jnp.asarray(b), tol=tol,
                                max_iters=max_iters)
    stats = {}
    got = cg.cg_solve_dense(_t(K)[0], _t(b)[0], tol=tol, max_iters=max_iters,
                            stats=stats)
    _close(got, ref, 1e-9)
    if max_iters == 7:
        assert stats["iters"] == [7]


def test_cg_solve_nan_returns_last_finite_iterate():
    """A matvec that turns NaN ends the loop with the last finite iterate,
    as the reference's bail-out does."""
    calls = []

    def matvec(v):
        calls.append(1)
        out = 2.0 * v
        return out * float("nan") if len(calls) > 3 else out

    b = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    x = cg.cg_solve(matvec, b, tol=1e-30, max_iters=50)
    assert torch.isfinite(x).all()
    with pytest.raises(ValueError, match="single-RHS"):
        cg.cg_solve(matvec, b[:, None])


def test_nystroem_colliding_inducing_points_finite():
    """Inducing points 5e-7 apart leave float32 K_mm singular: the jitter
    escalation (probe factorisations on a detached K_mm, then one
    differentiable Cholesky) keeps the value, its gradient with respect to
    ℓ and z, and the posterior finite (``tests/test_approx.py:237``)."""
    rng = np.random.default_rng(7)
    x = np.sort(rng.uniform(0, 1, (400, 1)), 0).astype(np.float32)
    y = (np.sin(6 * x[:, 0]) + 0.1 * rng.standard_normal(400)).astype(np.float32)
    base = x[::25][:16]
    z = np.concatenate([base, base + 5e-7], axis=0)
    k = gpt.SquaredExponentialKernel().set_params(
        {"lengthscale": torch.tensor(0.05)})
    X, Y = torch.from_numpy(x), torch.from_numpy(y)
    Z = torch.from_numpy(z).requires_grad_(True)
    st = ny.nystroem_factor(k, X, Z.detach(), torch.tensor(0.005), JITTER)
    assert torch.isfinite(st.L_mm).all() and torch.isfinite(st.L_core).all()
    with k.differentiable() as p:
        val = ny.nystroem_mll(k, X, Y, Z, torch.tensor(0.005), JITTER)
        g_ls, g_z = torch.autograd.grad(val, [p["lengthscale"], Z])
    assert torch.isfinite(val) and torch.isfinite(g_ls)
    assert torch.isfinite(g_z).all()
    xt = torch.linspace(0.0, 1.0, 50)[:, None]
    mu, var = ny.nystroem_posterior(k, X, Y, Z.detach(), xt,
                                    torch.tensor(0.005), JITTER)
    assert torch.isfinite(mu).all() and torch.isfinite(var).all()
    assert bool((var >= 0).all())
