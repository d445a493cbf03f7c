"""The port's pivoted Cholesky, mBCG and preconditioner against the JAX
package (float64) and against direct solves."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.linalg.pivchol import (
    partial_pivoted_cholesky as jax_pivchol,
)
from gaussianprocessfundamentals_tpu.models.iterative import (
    build_preconditioner as jax_build_preconditioner,
)
from gaussianprocessfundamentals_tpu_torch.linalg.mbcg import mbcg
from gaussianprocessfundamentals_tpu_torch.linalg.pivchol import (
    partial_pivoted_cholesky,
)
from gaussianprocessfundamentals_tpu_torch.models.iterative import (
    build_preconditioner,
)

# The suite runs one pytest-xdist worker per core: torch's own thread pool
# on top of that oversubscribes the CPU and slows every worker.
torch.set_num_threads(1)


def _se_pair(ls, d=1):
    jk = gpf.SquaredExponentialKernel(dim=d)
    tk = gpt.SquaredExponentialKernel(dim=d)
    tk.set_params({"lengthscale": torch.tensor(ls, dtype=torch.float64)})
    return jk, {"lengthscale": jnp.asarray(ls)}, tk


@pytest.mark.parametrize("d,ls,k", [(3, 0.5, 30), (2, 0.3, 20)])
def test_pivoted_cholesky_matches_jax(d, ls, k):
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (300, d))
    jk, jp, tk = _se_pair(ls, d)
    ref = np.asarray(jax_pivchol(jk, jp, jnp.asarray(x), k))
    got = partial_pivoted_cholesky(tk, torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_pivoted_cholesky_freezes_past_numerical_rank():
    """d = 1 SE at ℓ = 0.3 has numerical rank far below 60: the factor stops
    there (zero columns, no blow-up) and still reproduces K."""
    x = torch.from_numpy(np.random.default_rng(12).uniform(0, 1, (200, 1)))
    _, _, tk = _se_pair(0.3)
    L = partial_pivoted_cholesky(tk, x, 60)
    assert torch.isfinite(L).all()
    assert (L[:, -10:] == 0).all()
    torch.testing.assert_close(L @ L.T, tk.gram(x, x), rtol=0, atol=1e-10)


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("early_exit", [False, True])
def test_mbcg_solves_match_direct_solve(precond, early_exit):
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.uniform(0, 1, (250, 1)))
    _, _, tk = _se_pair(0.1)
    A = tk.gram(x, x) + 0.05 * torch.eye(250, dtype=torch.float64)
    B = torch.from_numpy(rng.standard_normal((250, 4)))
    M = None
    if precond:
        M, _, _, _, _ = build_preconditioner(tk, x, 20, 0.05)
    res = mbcg(lambda V: A @ V, B, max_iters=250, tol=1e-11, precond=M,
               early_exit=early_exit)
    torch.testing.assert_close(res.solves, torch.linalg.solve(A, B),
                               rtol=1e-7, atol=1e-8)
    assert res.resid_norm.max() < 1e-10
    if early_exit:
        assert res.iters < 250
        assert (res.alphas[res.iters:] == 0).all()


def test_mbcg_zero_column_freezes_without_nans():
    A = torch.diag(torch.arange(1.0, 51.0, dtype=torch.float64))
    B = torch.zeros(50, 2, dtype=torch.float64)
    B[:, 1] = 1.0
    res = mbcg(lambda V: A @ V, B, max_iters=60, tol=1e-12, early_exit=True)
    assert torch.isfinite(res.solves).all()
    assert (res.solves[:, 0] == 0).all()
    torch.testing.assert_close(res.solves[:, 1], 1.0 / torch.diagonal(A))


def test_build_preconditioner_matches_jax():
    """P⁻¹V, the singular values and log|P| agree with the JAX build (TSQR +
    Jacobi SVD there, torch QR + float64 SVD here). W_b is not compared:
    its columns are sign-ambiguous."""
    rng = np.random.default_rng(14)
    n, m, noise = 400, 32, 0.01
    x = rng.uniform(0, 1, (n, 1))
    V = rng.standard_normal((n, 3))
    jk, jp, tk = _se_pair(0.1)
    jP, _, jsv, _, jlogP = jax_build_preconditioner(jk, jp, jnp.asarray(x), m, noise)
    tP, W_b, tsv, _, tlogP = build_preconditioner(tk, torch.from_numpy(x), m, noise)
    ref = np.asarray(jP(jnp.asarray(V)))
    got = tP(torch.from_numpy(V)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8 * np.abs(ref).max())
    np.testing.assert_allclose(np.sort(tsv.numpy()), np.sort(np.asarray(jsv)),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(float(tlogP), float(jlogP), rtol=1e-12)
    WtW = W_b.T @ W_b
    live = tsv > 0
    torch.testing.assert_close(WtW[live][:, live],
                               torch.eye(int(live.sum()), dtype=torch.float64),
                               rtol=0, atol=1e-12)


def test_preconditioner_qr_soundness_guard(monkeypatch):
    """A garbage QR degrades the preconditioner to σ²I (correct but slower)
    instead of poisoning every solve; the healthy build keeps its basis."""
    n, m, noise = 600, 32, 0.01
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.sort(rng.uniform(0, 1, (n, 1)), 0).astype(np.float32))
    tk = gpt.SquaredExponentialKernel()
    tk.set_params({"lengthscale": torch.tensor(0.1)})

    def garbage_qr(A, mode="reduced"):
        nn, mm = A.shape
        return (torch.from_numpy(rng.standard_normal((nn, mm)) * 1e3).to(A.dtype),
                torch.from_numpy(rng.standard_normal((mm, mm))).to(A.dtype))

    monkeypatch.setattr(torch.linalg, "qr", garbage_qr)
    P_inv, W_b, sv, d_rng, log_P = build_preconditioner(tk, x, m, noise)
    assert float(W_b.abs().max()) == 0.0
    v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    torch.testing.assert_close(P_inv(v), v / noise, rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(log_P), n * np.log(noise), rtol=1e-4)
    monkeypatch.undo()
    _, W_ok, _, _, log_ok = build_preconditioner(tk, x, m, noise)
    assert float(W_ok.abs().max()) > 0.0
    assert float(log_ok) > n * np.log(noise)


@pytest.mark.parametrize("shape", [(5,), (129,), (1000,), (3, 257), (2, 4, 300)])
def test_tri_inverse_gives_the_cholesky_inverse(shape):
    """L⁻ᵀL⁻¹ from ``tri_inverse`` (the NLL backward's Kₙ⁻¹) against
    ``torch.cholesky_inverse``, float64, batched and at sizes that split
    unevenly and that sit at the leaf size: within 1e-13 of max|ref|; and
    L·L⁻¹ = I within 1e-12."""
    from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import (
        tri_inverse,
    )

    g = torch.Generator().manual_seed(shape[-1])
    n = shape[-1]
    A = torch.randn(*shape, n, generator=g, dtype=torch.float64)
    L = torch.linalg.cholesky(A @ A.mT + n * torch.eye(n, dtype=torch.float64))
    L_inv = tri_inverse(L)
    ref = torch.cholesky_inverse(L)
    assert float((L_inv.mT @ L_inv - ref).abs().max()) <= (
        1e-13 * float(ref.abs().max()))
    eye = torch.eye(n, dtype=torch.float64)
    assert float((L @ L_inv - eye).abs().max()) <= 1e-12
    assert torch.equal(torch.triu(L_inv, diagonal=1),
                       torch.zeros_like(L_inv))
