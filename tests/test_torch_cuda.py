"""The CUDA kernels on the card: K1 (Gram·V) and K2 (the low-rank-cotangent
gradient). Marked ``cuda``: skipped where no GPU is present, run on one with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest pins JAX, which the GPU machine
need not have; this file imports no JAX). K1's tolerances are those of
``test_torch_gram_matvec.py``, K2's those of ``test_torch_lowrank_vjp.py``.
"""
import pytest
import torch

import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu_torch.ops import cuda_gram, cuda_lrvjp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.mark.parametrize("kind,d,rtol", [("se", 1, 5e-5), ("mat32", 1, 5e-5),
                                         ("mat52", 1, 5e-5), ("se", 3, 5e-4),
                                         ("se", 6, 5e-4)])
@pytest.mark.parametrize("r", [1, 3, 9, 64, 257])
def test_kernel_matches_plain_on_card(cuda, kind, d, rtol, r):
    g = torch.Generator().manual_seed(0)
    x1 = torch.rand(1000, d, generator=g).to(cuda)
    x2 = torch.rand(1501, d, generator=g).to(cuda)
    V = torch.randn(1501, r, generator=g).to(cuda)
    before = cuda_gram.fused_gram_matvec_cross.launches
    got = cuda_gram.fused_gram_matvec_cross(x1, x2, V, 0.3, 1.2, kind)
    torch.cuda.synchronize()
    assert cuda_gram.fused_gram_matvec_cross.launches == before + 1
    ref = cuda_gram.plain_gram_matvec_cross(x1, x2, V, 0.3, 1.2, kind)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= rtol * float(ref.abs().max())


def test_kernel_refuses_what_it_does_not_cover(cuda):
    x = torch.rand(10, 2, device=cuda)
    V = torch.rand(10, 1, device=cuda)
    with pytest.raises(NotImplementedError, match="K3"):
        cuda_gram.fused_gram_matvec_cross(x, x, V, 0.3, 1.0, "mat52")
    with pytest.raises(TypeError):
        cuda_gram.fused_gram_matvec_cross(x.double(), x.double(), V.double(),
                                          0.3, 1.0, "se")
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_gram.fused_gram_matvec_cross(x, x, V.requires_grad_(), 0.3, 1.0, "se")
    k = gpt.Matern32Kernel(dim=2)
    k.set_params({"lengthscale": torch.tensor(0.3)})
    with pytest.raises(NotImplementedError, match="K3"):
        cuda_gram.fused_matvec_for(k.to(cuda), x)


def test_ard_se_routes_through_the_kernel(cuda):
    k = gpt.SquaredExponentialKernel(dim=3)
    k.set_params({"lengthscale": torch.tensor([0.2, 0.4, 0.8])})
    k = k.to(cuda)
    x = torch.rand(700, 3, device=cuda)
    V = torch.randn(700, 5, device=cuda)
    before = cuda_gram.fused_gram_matvec_cross.launches
    got = cuda_gram.fused_matvec_for(k, x)(V)
    assert cuda_gram.fused_gram_matvec_cross.launches == before + 1
    ref = k.gram(x, x) @ V
    assert float((got - ref).abs().max()) <= 5e-4 * float(ref.abs().max())


def test_pcg_precond_50k(cuda):
    """The preconditioner stays healthy where f32 is tight: the JAX gate
    ``pcg_precond_50k`` (benchmarks/check_pallas_tpu.py), with the float64
    SVD of the [m, m] factor in place of the float32 Jacobi SVD. PCG on
    [y | z], z ~ N(0, P), 30 iterations: every column's relative residual
    < 0.05."""
    from gaussianprocessfundamentals_tpu_torch.linalg.mbcg import mbcg
    from gaussianprocessfundamentals_tpu_torch.models.iterative import (
        build_preconditioner,
    )

    n, m, noise = 50_000, 256, 0.01
    g = torch.Generator().manual_seed(0)
    x = torch.sort(torch.rand(n, 1, generator=g), dim=0).values.to(cuda)
    y = torch.sin(8 * x[:, 0]) + 0.1 * torch.randn(n, generator=g).to(cuda)
    k = gpt.SquaredExponentialKernel()
    k.set_params({"lengthscale": torch.tensor(0.1)})
    k = k.to(cuda)
    P_inv, W_b, sv, _, _ = build_preconditioner(k, x, m, noise)
    u = torch.randn(n, 4, generator=g).to(cuda)
    w = torch.randn(m, 4, generator=g).to(cuda)
    z = noise ** 0.5 * u + W_b @ (sv[:, None] * w)
    B = torch.cat([y[:, None], z], dim=1)
    kmv = cuda_gram.fused_matvec_for(k, x)
    res = mbcg(lambda V: kmv(V) + noise * V, B, max_iters=30, tol=3e-3,
               precond=P_inv, early_exit=True)
    rel = res.resid_norm / torch.linalg.norm(B, dim=0)
    assert float(rel.max()) < 0.05, rel


@pytest.mark.parametrize("kind,d", [("se", 1), ("mat32", 1), ("mat52", 1),
                                    ("se", 3)])
@pytest.mark.parametrize("r", [1, 17, 145, 273])
def test_k2_matches_plain_on_card(cuda, kind, d, r):
    """Relative error per scalar ≤ 1e-3 (the JAX gate ``fused_lrvjp_*``);
    the cotangent has a non-zero mean, so the sums do not cancel."""
    g = torch.Generator().manual_seed(1)
    x1 = torch.rand(3000, d, generator=g).to(cuda)
    x2 = torch.rand(5001, d, generator=g).to(cuda)
    U = (0.5 + torch.randn(3000, r, generator=g)).to(cuda)
    W = (0.5 + torch.randn(5001, r, generator=g)).to(cuda)
    before = cuda_lrvjp.fused_lowrank_vjp_cross.launches
    got = cuda_lrvjp.fused_lowrank_vjp_cross(x1, x2, U, W, 0.2, 1.3, kind)
    torch.cuda.synchronize()
    assert cuda_lrvjp.fused_lowrank_vjp_cross.launches == before + 1
    ref = cuda_lrvjp.plain_lowrank_vjp_cross(x1, x2, U, W, 0.2, 1.3, kind)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and torch.isfinite(a)
        assert abs(float(a) - float(b)) <= 1e-3 * abs(float(b)), (float(a), float(b))


@pytest.mark.parametrize("kind,d", [("se", 1), ("mat32", 1), ("mat52", 1),
                                    ("se", 3)])
def test_k2_matches_f64_plain_on_cancelling_cotangent(cuda, kind, d):
    """A zero-mean cotangent, whose sums cancel as the fit's do, so a kernel
    that pairs the wrong rows or columns of U and W is far off: relative
    error per scalar ≤ 1e-4 against the plain version run in float64."""
    g = torch.Generator().manual_seed(3)
    x1 = torch.rand(3000, d, generator=g).to(cuda)
    x2 = torch.rand(5001, d, generator=g).to(cuda)
    U = torch.randn(3000, 273, generator=g).to(cuda)
    W = torch.randn(5001, 273, generator=g).to(cuda)
    got = cuda_lrvjp.fused_lowrank_vjp_cross(x1, x2, U, W, 0.2, 1.3, kind)
    ref = cuda_lrvjp.plain_lowrank_vjp_cross(
        x1.double(), x2.double(), U.double(), W.double(), 0.2, 1.3, kind)
    for a, b in zip(got, ref):
        assert torch.isfinite(a)
        assert abs(float(a) - float(b)) <= 1e-4 * abs(float(b)), (float(a), float(b))


def test_k2_refuses_what_it_does_not_cover(cuda):
    x = torch.rand(10, 2, device=cuda)
    U = torch.rand(10, 3, device=cuda)
    with pytest.raises(NotImplementedError, match="K4"):
        cuda_lrvjp.fused_lowrank_vjp_cross(x, x, U, U, 0.3, 1.0, "mat32")
    with pytest.raises(TypeError):
        cuda_lrvjp.fused_lowrank_vjp_cross(x.double(), x.double(), U.double(),
                                           U.double(), 0.3, 1.0, "se")
    with pytest.raises(RuntimeError, match="analytically"):
        cuda_lrvjp.fused_lowrank_vjp_cross(x, x, U.requires_grad_(), U, 0.3,
                                           1.0, "se")
    ard = gpt.SquaredExponentialKernel(dim=2)
    ard.set_params({"lengthscale": torch.tensor([0.2, 0.4])})
    m52 = gpt.Matern52Kernel(dim=2)
    m52.set_params({"lengthscale": torch.tensor(0.3)})
    for k in (ard, m52):
        with pytest.raises(NotImplementedError, match="K4"):
            cuda_lrvjp.fused_lowrank_vjp_for(k.to(cuda), x)


def test_streamed_fit_step_runs_k2_once(cuda):
    """One iterative NLL + gradient on the streamed route: K1 once per CG
    iteration, K2 once, and the same numbers as the materialised route
    (K from ``gram``, autograd for the gradient) on the same probes."""
    from gaussianprocessfundamentals_tpu_torch.models.iterative import _core_impl

    n, s, m = 3000, 8, 64
    g = torch.Generator().manual_seed(2)
    x = torch.sort(torch.rand(n, 1, generator=g), dim=0).values.to(cuda)
    y = torch.sin(8 * x[:, 0]) + 0.1 * torch.randn(n, generator=g).to(cuda)
    u = torch.randn(n, s, generator=g).to(cuda)
    w = torch.randn(m, s, generator=g).to(cuda)
    k = gpt.SquaredExponentialKernel(scaled=True)
    k.set_params({"lengthscale": torch.tensor(0.1),
                  "variance": torch.tensor(1.2)})
    k = k.to(cuda)
    kw = dict(max_iters=20, tol=1e-4, precond_m=m, early_exit=False)
    cuda_gram.fused_gram_matvec_cross.launches = 0
    cuda_lrvjp.fused_lowrank_vjp_cross.launches = 0
    streamed = _core_impl(k, x, y, 0.01, u, w, materialize=False, **kw)
    assert cuda_gram.fused_gram_matvec_cross.launches == 20
    assert cuda_lrvjp.fused_lowrank_vjp_cross.launches == 1
    dense = _core_impl(k, x, y, 0.01, u, w, materialize=True, **kw)
    assert cuda_lrvjp.fused_lowrank_vjp_cross.launches == 1
    for p in ("lengthscale", "variance"):
        a, b = float(streamed[5][p]), float(dense[5][p])
        assert abs(a - b) <= 1e-2 * abs(b), (p, a, b)
    assert abs(float(streamed[0]) - float(dense[0])) <= 1e-3 * abs(float(dense[0]))


def test_facade_defaults_to_the_card_and_fits_there(cuda):
    gp = gpt.GaussianProcess(gpt.SquaredExponentialKernel(scaled=True))
    assert gp.device.type == "cuda"
    x = torch.rand(500, 1, device=cuda)
    y = torch.sin(8 * x[:, 0])
    res = gp.fit(x, y, method="iterative", steps=3, precond_m=32)
    assert torch.isfinite(res.history).all()
    assert gp.kernel.lengthscale.device.type == "cuda"
