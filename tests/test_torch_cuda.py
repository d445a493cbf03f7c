"""The CUDA kernel on the card. Marked ``cuda``: skipped where no GPU is
present, run on one with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest pins JAX, which the GPU machine
need not have; this file imports no JAX). Tolerances are those of
``test_torch_gram_matvec.py``.
"""
import pytest
import torch

import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu_torch.ops import cuda_gram

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
