"""The CUDA kernels on the card: K1 (Gram·V), K2 (the low-rank-cotangent
gradient), the composite-expression kernels K3 and K4, and the dense Gram
kernels K5 and K6 with the dense route around them and the Nyström
posterior they serve; and the MCMC path on the card (the stacked NLL, a
lock-step NUTS transition against the CPU, one host read per doubling),
which launches none of them. Marked ``cuda``:
skipped where no GPU is present, run on one with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest pins JAX, which the GPU machine
need not have; this file imports no JAX). K1's tolerances are those of
``test_torch_gram_matvec.py``, K2's those of ``test_torch_lowrank_vjp.py``,
K3's and K4's those of ``chip_smoke.py`` phases 11 and 12, K5's and K6's
the JAX gates ``se_gram_*`` and ``matern*_gram_d1`` (2e-5·max|ref|), at
any d and, for K6, in the Euclidean form.
"""
import copy

import pytest
import torch

import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import noised
from gaussianprocessfundamentals_tpu_torch.models.exact import prior_draws
from gaussianprocessfundamentals_tpu_torch.ops import (
    cuda_dense_gram,
    cuda_expr,
    cuda_gram,
    cuda_lrvjp,
    expr,
)
from gaussianprocessfundamentals_tpu_torch.ops.gram_matvec import (
    lowrank_gram_vjp_cross,
    streamed_gram_matvec_cross,
)
from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.cuda


def _kernel_launches():
    """K1-K4's launch counts."""
    return (cuda_gram.fused_gram_matvec_cross.launches,
            cuda_lrvjp.fused_lowrank_vjp_cross.launches,
            cuda_expr.expr_gram_matvec_cross.launches,
            cuda_expr.expr_lowrank_vjp_cross.launches)


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
@pytest.mark.parametrize("r", [1, 3, 8, 9, 16, 64, 255, 256, 257])
@pytest.mark.parametrize("n1,n2", [(1000, 1501), (77, 2053)])
def test_kernel_matches_plain_on_card(cuda, kind, d, rtol, r, n1, n2):
    g = torch.Generator().manual_seed(0)
    x1 = torch.rand(n1, d, generator=g).to(cuda)
    x2 = torch.rand(n2, d, generator=g).to(cuda)
    V = torch.randn(n2, r, generator=g).to(cuda)
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
    # beyond K1 and K3 both: the router takes the plain row-panel version,
    # with no kernel launch
    k = gpt.Matern32Kernel(dim=9)
    k.set_params({"lengthscale": torch.tensor(0.3)})
    k = k.to(cuda)
    x9 = torch.rand(300, 9, device=cuda)
    V9 = torch.randn(300, 4, device=cuda)
    before = _kernel_launches()
    got = cuda_gram.fused_matvec_for(k, x9)(V9)
    assert _kernel_launches() == before
    ref = streamed_gram_matvec_cross(k, x9, x9, V9)
    assert torch.equal(got, ref)


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
    # ARD and Matérn at d > 1 go to K4 now
    ard = gpt.SquaredExponentialKernel(dim=2)
    ard.set_params({"lengthscale": torch.tensor([0.2, 0.4])})
    m52 = gpt.Matern52Kernel(dim=2)
    m52.set_params({"lengthscale": torch.tensor(0.3)})
    before = cuda_expr.expr_lowrank_vjp_cross.launches
    U = torch.rand(10, 3, device=cuda)
    for k in (ard, m52):
        g = cuda_lrvjp.fused_lowrank_vjp_for(k.to(cuda), x)(U, U)
        assert torch.isfinite(g["lengthscale"]).all()
    assert cuda_expr.expr_lowrank_vjp_cross.launches == before + 2
    # malformed parameters: the router names the fault
    per = gpt.PeriodicKernel(dim=2)
    per.set_params({"lengthscale": torch.tensor([0.2, 0.3]),
                    "period": torch.tensor(0.4)})
    with pytest.raises(NotImplementedError, match="cannot be per-dimension"):
        cuda_lrvjp.fused_lowrank_vjp_for(per.to(cuda), x)
    # SE at d = 9 is K2's, as in the JAX package
    se9 = gpt.SquaredExponentialKernel(dim=9, scaled=True)
    se9.set_params({"lengthscale": torch.tensor(0.8),
                    "variance": torch.tensor(1.3)})
    x9 = torch.rand(300, 9, device=cuda)
    U9 = torch.randn(300, 5, device=cuda)
    before = cuda_lrvjp.fused_lowrank_vjp_cross.launches
    g = cuda_lrvjp.fused_lowrank_vjp_for(se9.to(cuda), x9)(U9, U9)
    assert cuda_lrvjp.fused_lowrank_vjp_cross.launches == before + 1
    ref = lowrank_gram_vjp_cross(copy.deepcopy(se9).double(), x9.double(),
                                 x9.double(), U9.double(), U9.double())
    for name in ("lengthscale", "variance"):
        assert abs(float(g[name]) - float(ref[name])) <= 1e-4 * abs(
            float(ref[name])), name
    # beyond K2 and K4 both (Matérn-3/2 at d = 9): the router takes the
    # plain streamed version, with no kernel launch
    wide = gpt.Matern32Kernel(dim=9, scaled=True)
    wide.set_params({"lengthscale": torch.tensor(0.8),
                     "variance": torch.tensor(1.3)})
    wide = wide.to(cuda)
    before = _kernel_launches()
    got = cuda_lrvjp.fused_lowrank_vjp_for(wide, x9)(U9, U9)
    assert _kernel_launches() == before
    ref = lowrank_gram_vjp_cross(wide, x9, x9, U9, U9)
    for name in ("lengthscale", "variance"):
        assert torch.equal(got[name], ref[name]), name


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


def _expr(name, cuda):
    """The expressions of chip_smoke.py phases 11 and 12, at small n."""
    ard = [0.2, 0.3, 0.4]
    cases = {
        "se-ard-d3": (gpt.SquaredExponentialKernel(dim=3, scaled=True),
                      {"lengthscale": ard, "variance": 1.3}, 3),
        "per": (gpt.PeriodicKernel(scaled=True),
                {"lengthscale": 0.6, "period": 0.15, "variance": 0.9}, 1),
        # PER where its float32 phase is not accurate enough: at its
        # defaults, at ℓ's lower bound (5·range/n, n = 100k) and at the
        # period's (10·range/n)
        "per-default": (gpt.PeriodicKernel(scaled=True),
                        {"lengthscale": 0.1, "period": 0.1, "variance": 1.0}, 1),
        "per-sharp": (gpt.PeriodicKernel(scaled=True),
                      {"lengthscale": 5e-5, "period": 0.1, "variance": 1.0}, 1),
        "per-short": (gpt.PeriodicKernel(scaled=True),
                      {"lengthscale": 1.0, "period": 1e-4, "variance": 1.0}, 1),
        "lin-ard-d3": (gpt.LinearKernel(dim=3, scaled=True),
                       {"offset": [0.1, 0.5, 0.9], "variance": 0.7}, 3),
        "mat32": (gpt.Matern32Kernel(scaled=True),
                  {"lengthscale": 0.2, "variance": 0.7}, 1),
        "mat52-ard-d3": (gpt.Matern52Kernel(dim=3, scaled=True),
                         {"lengthscale": ard, "variance": 0.7}, 3),
        "rq": (gpt.RationalQuadraticKernel(scaled=True),
               {"lengthscale": 0.2, "alpha": 0.7, "variance": 1.1}, 1),
        "const": (gpt.ConstantKernel(scaled=True), {"c": 0.8, "variance": 1.5}, 1),
        "mauna": (gpt.SquaredExponentialKernel(scaled=True) * gpt.PeriodicKernel()
                  + gpt.SquaredExponentialKernel(scaled=True) + gpt.LinearKernel(),
                  {"children": ({"children": ({"lengthscale": 0.3, "variance": 0.05},
                                              {"lengthscale": 0.8, "period": 0.05})},
                                {"lengthscale": 0.15, "variance": 0.2},
                                {"offset": [0.4]})}, 1),
    }
    kernel, params, d = cases[name]
    kernel.set_params(_tensors(params))
    return kernel.to(cuda), d


def _tensors(tree):
    """A params tree of floats and lists as tensors (a list is one
    per-dimension vector)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tensors(v) for v in tree)
    return torch.tensor(tree, dtype=torch.float32)


EXPRS = ["se-ard-d3", "per", "lin-ard-d3", "mat32", "mat52-ard-d3", "rq",
         "const", "mauna"]
SHARP_PER = ["per-default", "per-sharp", "per-short"]


@pytest.mark.parametrize("name", EXPRS)
@pytest.mark.parametrize("r", [1, 8, 9, 16, 255, 256])
@pytest.mark.parametrize("n1,n2", [(700, 1301), (77, 2053)])
def test_k3_matches_plain_on_card(cuda, name, r, n1, n2):
    """Within 5e-5·max|ref| (the JAX gates ``expr_matvec_*``)."""
    kernel, d = _expr(name, cuda)
    g = torch.Generator().manual_seed(4)
    x1 = torch.rand(n1, d, generator=g).to(cuda)
    x2 = torch.rand(n2, d, generator=g).to(cuda)
    V = torch.randn(n2, r, generator=g).to(cuda)
    before = cuda_expr.expr_gram_matvec_cross.launches
    got = cuda_expr.expr_gram_matvec_cross(kernel, x1, x2, V)
    torch.cuda.synchronize()
    assert cuda_expr.expr_gram_matvec_cross.launches == before + 1
    ref = expr.plain_expr_gram_matvec_cross(kernel, x1, x2, V)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 5e-5 * float(ref.abs().max())


@pytest.mark.parametrize("name", SHARP_PER)
@pytest.mark.parametrize("r", [1, 9])
def test_k3_matches_f64_plain_on_card_for_sharp_per(cuda, name, r):
    """Within 5e-5·max|ref| of the plain version run in float64, where the
    float32 plain version is up to 4e-2 off: the kernel reduces PER's phase
    in float64."""
    kernel, d = _expr(name, cuda)
    g = torch.Generator().manual_seed(4)
    x1 = torch.rand(700, d, generator=g).to(cuda)
    x2 = torch.rand(1301, d, generator=g).to(cuda)
    V = torch.randn(1301, r, generator=g).to(cuda)
    got = cuda_expr.expr_gram_matvec_cross(kernel, x1, x2, V)
    ref = expr.plain_expr_gram_matvec_cross(
        copy.deepcopy(kernel).double(), x1.double(), x2.double(), V.double())
    assert torch.isfinite(got).all()
    assert float((got.double() - ref).abs().max()) <= 5e-5 * float(ref.abs().max())


@pytest.mark.parametrize("name", EXPRS + SHARP_PER)
@pytest.mark.parametrize("r", [1, 17, 273])
def test_k4_matches_plain_on_card(cuda, name, r):
    """Per parameter array max|diff| / max|ref| ≤ 3e-3 against the plain
    version run in float64 (the JAX gate ``expr_vjp_mauna``'s limit, with
    its zero-mean cotangent), PER at its sharp settings included."""
    kernel, d = _expr(name, cuda)
    g = torch.Generator().manual_seed(5)
    x1 = torch.rand(700, d, generator=g).to(cuda)
    x2 = torch.rand(1301, d, generator=g).to(cuda)
    U = (torch.randn(700, r, generator=g) / 700).to(cuda)
    W = torch.randn(1301, r, generator=g).to(cuda)
    before = cuda_expr.expr_lowrank_vjp_cross.launches
    got = cuda_expr.expr_lowrank_vjp_cross(kernel, x1, x2, U, W)
    torch.cuda.synchronize()
    assert cuda_expr.expr_lowrank_vjp_cross.launches == before + 1
    ref = expr.plain_expr_lowrank_vjp_cross(
        copy.deepcopy(kernel).double(), x1.double(), x2.double(), U.double(),
        W.double())
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    for _, slots, _ in expr.layout(kernel):
        for off, sz in slots.values():
            a, b = got[off:off + sz].double(), ref[off:off + sz]
            assert float((a - b).abs().max()) <= 3e-3 * float(b.abs().max()), (a, b)


@pytest.mark.parametrize("name", ["se", "mat32", "mat52", "se-d3", "se-d20",
                                  "se-d40", "mauna", "per", "se-ard-d3",
                                  "per-short"])
@pytest.mark.parametrize("r", [1, 7, 17, 272, 273])
@pytest.mark.parametrize("n1,n2", [(700, 1301), (77, 2053)])
def test_k2_k4_match_f64_plain_on_cancelling_cotangent(cuda, name, r, n1, n2):
    """The 3xTF32 cotangent tile of K2 and K4 (csrc/lowrank_mma.cuh) on a
    zero-mean cotangent, whose sums cancel, against the plain version run
    in float64: K2 per scalar within 1e-4, K4 per parameter array within
    2e-4 of max|ref| (chip_smoke.py's K2_RTOL_CANCEL and K4_RTOL_F64), at
    ragged r (r = 1 and 7 below one k-step, 17 and 273 ending in a part
    one; r = 272 takes 16-byte copies, the others 4-byte ones), at SE's
    run-time widths (d = 20 and 40: a part chunk of 32 dimensions) and at
    n1, n2 that are not multiples of the 128-row tile."""
    g = torch.Generator().manual_seed(6)
    # (kind, d, lengthscale): wider inputs, longer lengthscales
    leaf = {"se": ("se", 1, 0.2), "mat32": ("mat32", 1, 0.2),
            "mat52": ("mat52", 1, 0.2), "se-d3": ("se", 3, 0.2),
            "se-d20": ("se", 20, 0.9), "se-d40": ("se", 40, 1.3)}.get(name)
    d = leaf[1] if leaf else _expr(name, cuda)[1]
    x1 = torch.rand(n1, d, generator=g).to(cuda)
    x2 = torch.rand(n2, d, generator=g).to(cuda)
    U = torch.randn(n1, r, generator=g).to(cuda)
    W = torch.randn(n2, r, generator=g).to(cuda)
    f64 = [t.double() for t in (x1, x2, U, W)]
    if leaf:
        before = cuda_lrvjp.fused_lowrank_vjp_cross.launches
        got = cuda_lrvjp.fused_lowrank_vjp_cross(x1, x2, U, W, leaf[2], 1.3,
                                                 leaf[0])
        torch.cuda.synchronize()
        assert cuda_lrvjp.fused_lowrank_vjp_cross.launches == before + 1
        ref = cuda_lrvjp.plain_lowrank_vjp_cross(*f64, leaf[2], 1.3, leaf[0])
        for a, b in zip(got, ref):
            assert torch.isfinite(a)
            assert abs(float(a) - float(b)) <= 1e-4 * abs(float(b)), (float(a), float(b))
        return
    kernel, _ = _expr(name, cuda)
    before = cuda_expr.expr_lowrank_vjp_cross.launches
    got = cuda_expr.expr_lowrank_vjp_cross(kernel, x1, x2, U, W)
    torch.cuda.synchronize()
    assert cuda_expr.expr_lowrank_vjp_cross.launches == before + 1
    ref = expr.plain_expr_lowrank_vjp_cross(copy.deepcopy(kernel).double(), *f64)
    assert torch.isfinite(got).all()
    for _, slots, _ in expr.layout(kernel):
        for off, sz in slots.values():
            a, b = got[off:off + sz].double(), ref[off:off + sz]
            assert float((a - b).abs().max()) <= 2e-4 * float(b.abs().max()), (a, b)


def test_k2_k4_take_unaligned_operands_as_they_are(cuda):
    """U and W with r % 4 == 0 that are not 16-byte aligned (views one
    float into their storage) take the 4-byte copies of a ragged r and give
    bit for bit the sums of aligned copies of the same values."""
    g = torch.Generator().manual_seed(7)
    n1, n2, r = 300, 517, 16
    x1 = torch.rand(n1, 1, generator=g).to(cuda)
    x2 = torch.rand(n2, 1, generator=g).to(cuda)
    U = torch.randn(n1, r, generator=g).to(cuda)
    W = torch.randn(n2, r, generator=g).to(cuda)

    def shifted(M):
        out = torch.empty(M.numel() + 1, device=cuda)[1:].view(M.shape)
        return out.copy_(M)

    Us, Ws = shifted(U), shifted(W)
    assert Us.data_ptr() % 16 != 0 and Ws.data_ptr() % 16 != 0
    a = cuda_lrvjp.fused_lowrank_vjp_cross(x1, x2, U, W, 0.2, 1.3, "se")
    b = cuda_lrvjp.fused_lowrank_vjp_cross(x1, x2, Us, Ws, 0.2, 1.3, "se")
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    kernel, _ = _expr("mauna", cuda)
    assert torch.equal(cuda_expr.expr_lowrank_vjp_cross(kernel, x1, x2, U, W),
                       cuda_expr.expr_lowrank_vjp_cross(kernel, x1, x2, Us, Ws))


def test_k3_k4_refuse_what_they_do_not_cover(cuda):
    kernel, _ = _expr("mauna", cuda)
    x = torch.rand(10, 1, device=cuda)
    with pytest.raises(TypeError):
        cuda_expr.expr_gram_matvec_cross(kernel, x.double(), x.double(),
                                         x.double())
    with pytest.raises(RuntimeError, match="autograd"):
        cuda_expr.expr_lowrank_vjp_cross(kernel, x, x, x.requires_grad_(), x)
    wide = gpt.SquaredExponentialKernel(dim=9)
    wide.set_params({"lengthscale": torch.tensor([0.3] * 9)})
    x9 = torch.rand(10, 9, device=cuda)
    with pytest.raises(NotImplementedError, match="d=9 > 8"):
        cuda_expr.expr_gram_matvec_cross(wide.to(cuda), x9, x9, x9[:, :1])


def test_composite_streamed_step_runs_k3_per_iteration_and_k4_once(cuda):
    """One iterative NLL + gradient of the Mauna Loa composite (root
    WhiteNoise included) on the streamed route: K3 once per CG iteration,
    K4 once, and the same numbers as the materialised route on the same
    probes."""
    from gaussianprocessfundamentals_tpu_torch.models.iterative import _core_impl

    kernel, _ = _expr("mauna", cuda)
    full = kernel + gpt.WhiteNoiseKernel(scaled=True)
    full.terms[-1].set_params({"variance": torch.tensor(0.02)})
    full = full.to(cuda)
    n, s, m = 3000, 8, 64
    g = torch.Generator().manual_seed(6)
    x = torch.sort(torch.rand(n, 1, generator=g), dim=0).values.to(cuda)
    y = torch.sin(20 * x[:, 0]).to(cuda) + 0.1 * torch.randn(n, generator=g).to(cuda)
    u = torch.randn(n, s, generator=g).to(cuda)
    w = torch.randn(m, s, generator=g).to(cuda)
    kw = dict(max_iters=20, tol=1e-4, precond_m=m, early_exit=False)
    cuda_expr.expr_gram_matvec_cross.launches = 0
    cuda_expr.expr_lowrank_vjp_cross.launches = 0
    streamed = _core_impl(full, x, y, 0.01, u, w, materialize=False, **kw)
    assert cuda_expr.expr_gram_matvec_cross.launches == 20
    assert cuda_expr.expr_lowrank_vjp_cross.launches == 1
    dense = _core_impl(full, x, y, 0.01, u, w, materialize=True, **kw)
    for a, b in zip(tree_leaves(streamed[5]), tree_leaves(dense[5])):
        assert abs(float(a) - float(b)) <= 1e-2 * abs(float(b)), (float(a), float(b))
    assert abs(float(streamed[0]) - float(dense[0])) <= 1e-3 * abs(float(dense[0]))


def test_cross_router_with_white_noise_on_card(cuda):
    """The cross form with a root WhiteNoise (the posterior mean's
    K(x_test, x)·α): K3 on the stripped core plus the exact test/train
    coincidence term, against the full kernel's dense product."""
    core, _ = _expr("mauna", cuda)
    kernel = core + gpt.WhiteNoiseKernel(scaled=True)
    kernel.terms[-1].set_params({"variance": torch.tensor(0.02)})
    kernel = kernel.to(cuda)
    g = torch.Generator().manual_seed(7)
    x = torch.rand(900, 1, generator=g).to(cuda)
    xt = torch.cat([x[100:110], torch.rand(50, 1, generator=g).to(cuda)])
    V = torch.randn(900, 3, generator=g).to(cuda)
    before = cuda_expr.expr_gram_matvec_cross.launches
    got = cuda_gram.fused_matvec_cross_for(kernel, xt, x)(V)
    assert cuda_expr.expr_gram_matvec_cross.launches == before + 1
    ref = kernel.gram(xt, x) @ V
    assert float((got - ref).abs().max()) <= 5e-5 * float(ref.abs().max())


# --- K5 and K6: the dense Gram kernels --------------------------------------

@pytest.mark.parametrize("kind,d", [("se", 1), ("se", 2), ("se", 3), ("se", 5),
                                    ("se", 8), ("se", 9), ("se", 12),
                                    ("se", 20), ("se", 40), ("32", 1),
                                    ("52", 1), ("32", 2), ("52", 2),
                                    ("52", 12)])
@pytest.mark.parametrize("n,m,diag_add", [(700, 700, 0.0), (700, 700, 0.25),
                                          (333, 1001, 0.25), (1001, 258, 0.0),
                                          (515, 515, 0.25), (97, 3, 0.25)])
def test_dense_gram_matches_plain_on_card(cuda, kind, d, n, m, diag_add):
    """Square and cross, m at each residue mod 4 (the row starts' alignment
    to 16 bytes) and below 4, the diagonal on global row = column; d = 1-8
    compile-time widths, above 8 the run-time width (d = 40: two 32-wide
    chunks), the Matérn Euclidean at d > 1. The lengthscale grows as √d
    above d = 8, so that the Gram is not all zeros off the diagonal."""
    g = torch.Generator().manual_seed(n + m + d)
    x1 = torch.rand(n, d, generator=g).to(cuda)
    x2 = x1 if n == m else torch.rand(m, d, generator=g).to(cuda)
    ls = 0.3 if d <= 8 else 0.15 * d ** 0.5
    if kind == "se":
        fn, plain, extra = (cuda_dense_gram.se_gram,
                            cuda_dense_gram.plain_se_gram, {})
    else:
        fn, plain, extra = (cuda_dense_gram.matern_gram,
                            cuda_dense_gram.plain_matern_gram, {"nu": kind})
    before = fn.launches
    got = fn(x1, x2, ls, 1.3, diag_add, **extra)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = plain(x1, x2, ls, 1.3, diag_add, **extra)
    assert got.shape == (n, m) and torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())
    # the same scalars as 0-d device tensors, read by the kernel
    dev = [torch.tensor(v, device=cuda) for v in (ls, 1.3, diag_add)]
    assert torch.equal(fn(x1, x2, *dev, **extra), got)


def test_dense_gram_refuses_what_it_does_not_cover(cuda):
    x = torch.rand(10, 2, device=cuda)
    with pytest.raises(TypeError):
        cuda_dense_gram.se_gram(x.double(), x.double(), 0.3)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_dense_gram.se_gram(x.clone().requires_grad_(), x, 0.3)
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_dense_gram.se_gram(x, x.cpu(), 0.3)
    with pytest.raises(ValueError, match="scalars"):
        cuda_dense_gram.se_gram(x, x, torch.tensor([0.3, 0.4], device=cuda))


def test_dense_gram_builds_make_no_host_read(cuda):
    """The dense posterior's Gram builds (K + shift through noised_gram,
    K_s and K_ss through dense_gram_for) with the hyperparameters, the
    noise and the jitter floor on the device: no synchronisation, under
    torch.cuda.set_sync_debug_mode("error")."""
    g = torch.Generator().manual_seed(5)
    x = torch.rand(600, 1, generator=g).to(cuda)
    xt = torch.rand(50, 1, generator=g).to(cuda)
    cases = [
        (gpt.SquaredExponentialKernel(scaled=True).set_params(
            {"lengthscale": torch.tensor(0.2), "variance": torch.tensor(1.1)}),
         1),
        (gpt.SquaredExponentialKernel(dim=2, scaled=True).set_params({
            "lengthscale": torch.tensor([0.2, 0.4]),
            "variance": torch.tensor(0.9)}), 2),
        (gpt.Matern52Kernel(scaled=True).set_params(
            {"lengthscale": torch.tensor(0.1), "variance": torch.tensor(0.7)}),
         1),
    ]
    for k, d in cases:
        k = k.to(cuda)
        a, b = x.repeat(1, d), xt.repeat(1, d)
        noise = torch.tensor(1e-2, device=cuda)
        launches = (cuda_dense_gram.se_gram.launches
                    + cuda_dense_gram.matern_gram.launches)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            Kn = cuda_dense_gram.noised_gram(k, a, noise, 1e-8)
            Kf = cuda_dense_gram.noised_gram(k, a, 1e-2, 1e-8)
            K_s = cuda_dense_gram.dense_gram_for(k, a, b)
            K_ss = cuda_dense_gram.dense_gram_for(k, b, b, 1e-6)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert (cuda_dense_gram.se_gram.launches
                + cuda_dense_gram.matern_gram.launches) == launches + 4
        ref = noised(k.gram(a, a), 1e-2, 1e-8)
        eye = torch.eye(50, device=cuda)
        for got, want in ((Kn, ref), (Kf, ref), (K_s, k.gram(a, b)),
                          (K_ss, k.gram(b, b) + 1e-6 * eye)):
            assert float((got - want).abs().max()) <= (
                2e-5 * float(want.abs().max()))


@pytest.mark.parametrize("noise", ["tensor", "float"])
@pytest.mark.parametrize("name", ["se", "mat52"])
def test_dense_posterior_gram_builds_make_no_host_read(cuda, monkeypatch,
                                                        name, noise):
    """A dense posterior through the facade (``GaussianProcess.posterior``,
    method="dense", full_cov=True) with each of its Gram builds (K + shift,
    K_s, K_ss) run under torch.cuda.set_sync_debug_mode("error"), on the
    arguments the model passes them: the noise as a fit leaves it (a 0-d
    device tensor) or as a float, the jitter of the model's config. The
    Cholesky and the solves between the builds are outside the check."""
    from gaussianprocessfundamentals_tpu_torch.models import exact

    def strict(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run

    monkeypatch.setattr(exact, "noised_gram", strict(exact.noised_gram))
    monkeypatch.setattr(exact, "dense_gram_for",
                        strict(exact.dense_gram_for))
    g = torch.Generator().manual_seed(7)
    x = torch.sort(torch.rand(1000, 1, generator=g), dim=0).values
    y = torch.sin(8 * x[:, 0]) + 0.1 * torch.randn(1000, generator=g)
    xt = torch.linspace(0, 1, 60)[:, None]
    leaf = (gpt.SquaredExponentialKernel if name == "se"
            else gpt.Matern52Kernel)
    k = leaf(scaled=True).set_params(
        {"lengthscale": torch.tensor(0.1), "variance": torch.tensor(1.0)})
    gp = gpt.GaussianProcess(copy.deepcopy(k), noise=(
        torch.tensor(1e-2, device=cuda) if noise == "tensor" else 1e-2),
        device=cuda).set_data(x, y)
    wrapper = (cuda_dense_gram.se_gram if name == "se"
               else cuda_dense_gram.matern_gram)
    before = wrapper.launches
    post, cov = gp.posterior(xt, full_cov=True, method="dense")
    assert wrapper.launches == before + 3
    gp64 = gpt.GaussianProcess(copy.deepcopy(k).double(), noise=1e-2,
                               device=cuda).set_data(x.double(), y.double())
    ref, ref_cov = gp64.posterior(xt.double(), full_cov=True, method="dense")
    assert float((post.mean.double() - ref.mean).abs().max()) <= 1e-3
    assert float((cov.double() - ref_cov).abs().max()) <= (
        0.1 * float(ref_cov.abs().max()))


def test_dense_router_routes_by_kernel_type_and_dtype(cuda):
    x = torch.rand(300, 2, device=cuda)
    se = gpt.SquaredExponentialKernel(dim=2, scaled=True).set_params({
        "lengthscale": torch.tensor([0.2, 0.5]), "variance": torch.tensor(0.7)})
    se = se.to(cuda)
    before = cuda_dense_gram.se_gram.launches
    got = cuda_dense_gram.dense_gram_for(se, x, x, 0.1)
    assert cuda_dense_gram.se_gram.launches == before + 1
    ref = se.gram(x, x) + 0.1 * torch.eye(300, device=cuda)
    assert float((got - ref).abs().max()) <= 2e-5
    # float64 and composites take kernel.gram
    cuda_dense_gram.dense_gram_for(se.double(), x.double(), x.double())
    composite = (gpt.SquaredExponentialKernel(dim=2)
                 + gpt.LinearKernel(dim=2)).set_params({"children": (
                     {"lengthscale": torch.tensor(0.3)},
                     {"offset": torch.tensor([0.5, 0.5])})}).to(cuda)
    cuda_dense_gram.dense_gram_for(composite, x, x)
    assert cuda_dense_gram.se_gram.launches == before + 1


def test_dense_posterior_launches_two_gram_kernels(cuda):
    g = torch.Generator().manual_seed(3)
    x = torch.sort(torch.rand(2000, 1, generator=g), dim=0).values
    y = torch.sin(8 * x[:, 0]) + 0.1 * torch.randn(2000, generator=g)
    k = gpt.Matern52Kernel(scaled=True).set_params(
        {"lengthscale": torch.tensor(0.1), "variance": torch.tensor(1.0)})
    gp = gpt.GaussianProcess(k, noise=1e-2).set_data(x, y)
    xt = torch.linspace(0, 1, 100)[:, None]
    before = cuda_dense_gram.matern_gram.launches
    post = gp.posterior(xt)
    assert cuda_dense_gram.matern_gram.launches == before + 2
    gp64 = gpt.GaussianProcess(copy.deepcopy(k).double(),
                               noise=1e-2).set_data(x.double(), y.double())
    ref = gp64.posterior(xt.double())
    assert float((post.mean.double() - ref.mean).abs().max()) <= 1e-3
    # the variance is ~1e-4 of k_ss here: held relative to its own size
    assert float((post.var.double() - ref.var).abs().max()) <= (
        0.1 * float(ref.var.abs().max()))


def test_nystroem_posterior_launches_k5_per_gram_and_matches_f64(cuda):
    """The projected-process posterior through the facade after a Nyström
    fit: one K5 launch for each of K_nm, K_mm and K_tm, none in the fit
    (``kernel.gram`` under autograd), and μ within 1e-3·max|μ|, var within
    5e-2·max|var| of the CPU float64 ``nystroem_posterior`` at the same
    parameters, inducing set and jitter level."""
    from gaussianprocessfundamentals_tpu_torch.linalg.nystroem import (
        nystroem_jitter,
        nystroem_posterior,
    )

    g = torch.Generator().manual_seed(5)
    x = torch.sort(torch.rand(3000, 1, generator=g), dim=0).values
    y = torch.sin(8 * x[:, 0]) + 0.1 * torch.randn(3000, generator=g)
    xt = torch.linspace(0, 1, 100)[:, None]
    gp = gpt.GaussianProcess(gpt.SquaredExponentialKernel(scaled=True))
    before = cuda_dense_gram.se_gram.launches
    gp.fit(x, y, method="adam", steps=5, optimize_noise=True, noise=1e-2,
           approximation="nystroem", n_inducing=64, optimize_inducing=True)
    assert cuda_dense_gram.se_gram.launches == before
    post = gp.posterior(xt)
    assert cuda_dense_gram.se_gram.launches == before + 3
    z = gp.inducing
    with torch.no_grad():
        jit = float(nystroem_jitter(cuda_dense_gram.dense_gram_for(
            gp.kernel, z, z), 1e-8))
    k64 = copy.deepcopy(gp.kernel).double().cpu()
    mu, var = nystroem_posterior(k64, x.double(), y.double(),
                                 z.double().cpu(), xt.double(),
                                 gp.noise.double().cpu(), jit)
    assert float((post.mean.double().cpu() - mu).abs().max()) <= (
        1e-3 * float(mu.abs().max()))
    assert float((post.var.double().cpu() - var).abs().max()) <= (
        5e-2 * float(var.abs().max()))


def test_dense_router_refuses_hyperparameters_that_require_grad(cuda):
    """K5/K6 have no VJP: under autograd the router raises rather than
    hand back a Gram that silently carries no gradient to the kernel."""
    k = gpt.SquaredExponentialKernel(scaled=True).set_params(
        {"lengthscale": torch.tensor(0.2), "variance": torch.tensor(1.1)})
    k = k.to(cuda)
    x = torch.rand(64, 1, device=cuda)
    with k.differentiable():
        with pytest.raises(RuntimeError, match="forward-only"):
            cuda_dense_gram.dense_gram_for(k, x, x)
        with pytest.raises(RuntimeError, match="forward-only"):
            prior_draws(k, x, torch.randn(2, 64, device=cuda))
        with torch.no_grad():
            cuda_dense_gram.dense_gram_for(k, x, x)


def test_changepoint_and_partition_are_refused_off_the_dense_route(cuda):
    """The K1/K3 and K2/K4 routers have no tile code for ChangePoint and
    Partition: they take the plain streamed versions, as the JAX package
    does, and launch no kernel; the dense route serves them through
    kernel.gram."""
    cp = gpt.ChangePoint(children=(gpt.SquaredExponentialKernel(),
                                   gpt.SquaredExponentialKernel()))
    part = gpt.Partition(children=(gpt.SquaredExponentialKernel(),
                                   gpt.SquaredExponentialKernel()),
                         model=gpt.BoxPartitioning(edges=(0.5,)))
    x = torch.rand(50, 1, device=cuda)
    V = torch.randn(50, 3, device=cuda)
    for kernel in (cp, part):
        kernel.set_params(kernel.init_params([[0.0, 1.0]], 50)).to(cuda)
        assert cuda_gram.gram_route(kernel, 1) == "plain"
        assert cuda_lrvjp.vjp_route(kernel, 1) == "plain"
        before = _kernel_launches()
        got = cuda_gram.fused_matvec_for(kernel, x)(V)
        assert torch.equal(got, streamed_gram_matvec_cross(kernel, x, x, V))
        g = cuda_lrvjp.fused_lowrank_vjp_for(kernel, x)(V, V)
        ref = lowrank_gram_vjp_cross(kernel, x, x, V, V)
        for a, b in zip(tree_leaves(g), tree_leaves(ref)):
            assert torch.equal(a, b)
        assert _kernel_launches() == before
        gp = gpt.GaussianProcess(kernel, noise=1e-2).set_data(
            x, torch.sin(6 * x[:, 0]))
        assert torch.isfinite(gp.posterior(x[:5]).mean).all()


def test_gram_fn_with_k5_evaluates_the_nll_but_not_its_gradient(cuda):
    x = torch.rand(200, 1, device=cuda)
    y = torch.sin(6 * x[:, 0])
    k = gpt.SquaredExponentialKernel().to(cuda)
    u = {"kernel": {"lengthscale": torch.tensor(-1.5, device=cuda)},
         "mean": {}}
    gram_fn = lambda kern, a, b: cuda_dense_gram.se_gram(  # noqa: E731
        a, b, kern.lengthscale)
    nll = gpt.make_nll(k, gpt.ZeroMean(), x, y, fixed_noise=0.01,
                       gram_fn=gram_fn)
    ref = gpt.make_nll(k, gpt.ZeroMean(), x, y, fixed_noise=0.01)
    assert abs(float(nll(u)) - float(ref(u))) <= 1e-3 * abs(float(ref(u)))
    u["kernel"]["lengthscale"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        nll(u).backward()


def _fitted_svgp(kind, cuda, steps=20):
    """A short SVGP fit on the card: (kernel, params, x)."""
    g = torch.Generator().manual_seed(9)
    x = torch.rand(3000, 1, generator=g).to(cuda)
    y = torch.sin(12 * x[:, 0]) + 0.1 * torch.randn(3000, generator=g).to(cuda)
    leaf = (gpt.SquaredExponentialKernel if kind == "se"
            else gpt.Matern52Kernel)
    k = leaf(scaled=True).to(cuda)
    params, _ = gpt.fit_svgp(
        k, x, y, m=64, steps=steps, batch_size=512,
        generator=torch.Generator(device=cuda).manual_seed(0))
    return k, params, x


@pytest.mark.parametrize("kind,wrapper", [("se", "se_gram"),
                                          ("mat52", "matern_gram")])
def test_svgp_predict_launches_two_dense_grams(cuda, kind, wrapper):
    """``svgp_predict`` builds K_mm (+ its jitter floor) and K_mx with one
    K5 (SE) or K6 (Matérn-5/2 at d = 1) launch each, and agrees with the
    CPU float64 predictive at the same parameters and K_mm jitter (the
    float32 floor, 2000·eps·mean diag, is part of the model: it moves μ by
    up to 70% of its max in float64): μ within 1e-3·max|μ|, var within
    5e-2·max|var| (float32 against float64, as the dense posterior's
    checks)."""
    from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import (
        effective_jitter_of_diag,
    )
    from gaussianprocessfundamentals_tpu_torch.models.svgp import SVGPParams

    k, params, x = _fitted_svgp(kind, cuda)
    xt = torch.linspace(0, 1, 200, device=cuda)[:, None]
    fn = getattr(cuda_dense_gram, wrapper)
    before = _kernel_launches(), fn.launches
    mu, var = gpt.svgp_predict(k, params, xt)
    assert (_kernel_launches(), fn.launches) == (before[0], before[1] + 2)
    p64 = SVGPParams(
        {n: t.double().cpu() for n, t in params.kernel_u.items()},
        *(t.double().cpu() for t in params[1:]))
    k64 = copy.deepcopy(k).double().cpu()
    floor = float(effective_jitter_of_diag(k.diag(params.z), 1e-8, 2000.0))
    mu64, var64 = gpt.svgp_predict(k64, p64, xt.double().cpu(), jitter=floor)
    assert bool((var >= 0).all())
    assert float((mu.double().cpu() - mu64).abs().max()) <= (
        1e-3 * float(mu64.abs().max()))
    assert float((var.double().cpu() - var64).abs().max()) <= (
        5e-2 * float(var64.abs().max()))


@pytest.mark.parametrize("kind,wrapper", [("se", "se_gram"),
                                          ("mat52", "matern_gram")])
def test_pathwise_builds_launch_two_dense_grams(cuda, kind, wrapper):
    """``pathwise_from_draws`` builds K + (σ² + jitter)·I and K_s with one
    K5 or K6 launch each, and agrees with the same draws through the plain
    versions on the CPU within 1e-3·max|ref| (σ² = 0.1 keeps the float32
    CG's condition number ~1e4)."""
    from gaussianprocessfundamentals_tpu_torch.models import rff

    g = torch.Generator().manual_seed(4)
    x = torch.sort(torch.rand(800, 1, generator=g), dim=0).values
    y = torch.sin(8 * x[:, 0]) + 0.3 * torch.randn(800, generator=g)
    xt = torch.linspace(0, 1, 300)[:, None]
    leaf = (gpt.SquaredExponentialKernel if kind == "se"
            else gpt.Matern52Kernel)
    k = leaf(scaled=True).set_params({"lengthscale": torch.tensor(0.2),
                                      "variance": torch.tensor(1.0)})
    state = rff.rff_init(k, 1, 512, g)
    w = torch.randn(512, 8, generator=g)
    eps = torch.randn(8, 800, generator=g)
    ref = rff.pathwise_from_draws(k, x, y, xt, 0.1, state, w, eps,
                                  max_iters=100)
    kc = copy.deepcopy(k).to(cuda)
    fn = getattr(cuda_dense_gram, wrapper)
    before = _kernel_launches(), fn.launches
    got = rff.pathwise_from_draws(
        kc, x.to(cuda), y.to(cuda), xt.to(cuda), 0.1,
        rff.RFFState(*(t.to(cuda) for t in state)), w.to(cuda),
        eps.to(cuda), max_iters=100)
    assert (_kernel_launches(), fn.launches) == (before[0], before[1] + 2)
    assert float((got.cpu() - ref).abs().max()) <= (
        1e-3 * float(ref.abs().max()))


def test_svgp_adam_step_makes_no_host_read(cuda):
    """Three ``fit_svgp`` steps (minibatch drawn on the card, ELBO, guarded
    gradient, Adam) under torch.cuda.set_sync_debug_mode("error"), after
    two warm-up steps; one of them on a minibatch whose loss is NaN."""
    from gaussianprocessfundamentals_tpu_torch.models import svgp

    g = torch.Generator().manual_seed(2)
    x = torch.rand(5000, 1, generator=g).to(cuda)
    y = torch.sin(12 * x[:, 0]).contiguous()
    k = gpt.SquaredExponentialKernel(scaled=True).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params, opt = svgp.svgp_adam_init(
        svgp.init_svgp_params(k, x, 128, gen), 1e-2)
    y_nan = torch.full_like(y, float("nan"))

    def step(yy):
        idx = torch.randint(0, 5000, (1024,), generator=gen, device=cuda)
        return svgp.svgp_adam_step(k, params, opt, x[idx], yy[idx], 5000)

    hist = [step(y), step(y)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hist += [step(y), step(y_nan), step(y)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    h = torch.stack(hist).cpu()
    assert bool(torch.isnan(h[3])) and bool(torch.isfinite(h[[0, 1, 2, 4]]).all())
    assert all(bool(torch.isfinite(t).all()) for t in svgp.svgp_leaves(params))


def _gp_chains(device, n=300, C=4, seed=0):
    """The Matérn-5/2~s hyperposterior of BASELINE config 3 (N(0, 3²) prior
    on the unconstrained leaves) on ``make_stacked_nll`` in float64, and C
    starting points near its mode."""
    g = torch.Generator().manual_seed(seed)
    x = torch.sort(torch.rand(n, 1, generator=g, dtype=torch.float64),
                   dim=0).values
    y = torch.sin(8 * x[:, 0]) + 0.1 * torch.randn(n, generator=g,
                                                   dtype=torch.float64)
    nll = gpt.make_stacked_nll(gpt.Matern52Kernel(scaled=True).to(device),
                               gpt.ZeroMean(), x.to(device), y.to(device),
                               optimize_noise=True)

    def lp(u):
        return -nll(u) - 0.5 * sum((l ** 2).reshape(C, -1).sum(-1)
                                   for l in tree_leaves(u)) / 9.0

    base = torch.tensor([-1.5, 0.0, -4.5], dtype=torch.float64)
    q = (base + 0.1 * torch.randn(C, 3, generator=g,
                                  dtype=torch.float64)).to(device)
    return lp, {"kernel": {"lengthscale": q[:, 0], "variance": q[:, 1]},
                "mean": {}, "log_noise": q[:, 2]}


def test_make_stacked_nll_on_card_matches_make_nll(cuda):
    """``make_stacked_nll`` of 4 parameter sets on the card against 4 calls
    of ``make_nll``, value and gradient in float64 within 1e-10 relative."""
    from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_map

    g = torch.Generator().manual_seed(3)
    x = torch.rand(500, 1, generator=g, dtype=torch.float64).to(cuda)
    y = torch.sin(6 * x[:, 0])
    k = gpt.Matern52Kernel(scaled=True).to(cuda)
    u = {"kernel": {"lengthscale": torch.tensor([-2.0, -1.5, -1.0, -0.5]),
                    "variance": torch.tensor([0.0, 0.3, -0.3, 0.1])},
         "mean": {}, "log_noise": torch.tensor([-4.0, -3.0, -5.0, -2.0])}
    u = tree_map(lambda t: t.double().to(cuda).requires_grad_(True), u)
    stacked = gpt.make_stacked_nll(k, gpt.ZeroMean(), x, y,
                                   optimize_noise=True)(u)
    grads = torch.autograd.grad(stacked.sum(), tree_leaves(u))
    single = gpt.make_nll(k, gpt.ZeroMean(), x, y, optimize_noise=True)
    for c in range(4):
        uc = tree_map(lambda t: t[c].detach().requires_grad_(True), u)
        v = single(uc)
        gc = torch.autograd.grad(v, tree_leaves(uc))
        assert abs(float(stacked[c].detach()) - float(v.detach())) <= (
            1e-10 * abs(float(v.detach())))
        for a, b in zip(grads, gc):
            assert abs(float(a[c]) - float(b)) <= 1e-10 * max(1.0, abs(float(b)))


def test_nuts_transition_on_card_matches_cpu(cuda):
    """One lock-step transition of 4 GP chains (n = 300, float64) on the
    card and on the CPU from the same draws: leapfrog counts and
    divergences identical, positions within 1e-8."""
    from gaussianprocessfundamentals_tpu_torch.mcmc import nuts as tnuts
    from gaussianprocessfundamentals_tpu_torch.mcmc.hmc import value_and_grad
    from gaussianprocessfundamentals_tpu_torch.utils.tree import ravel_tree

    outs = []
    draws = None
    for device in ("cpu", cuda):
        lp, u0 = _gp_chains(device)
        q, unravel = ravel_tree(u0, batch_ndim=1)
        lpg = value_and_grad(lp, unravel)
        if draws is None:
            draws = tnuts.generator_draws(torch.Generator().manual_seed(9),
                                          q, 6)(0)
        d = tnuts.NUTSDraws(*(t.to(device) for t in draws))
        lp0, g0 = lpg(q)
        eps = torch.tensor([0.1, 0.3, 0.5, 0.8], dtype=torch.float64,
                           device=device)
        outs.append(tnuts.nuts_transition(
            lpg, 6, d, q, lp0, g0, eps,
            torch.tensor([0.1, 0.3, 0.1], dtype=torch.float64,
                         device=device).expand(4, 3)))
    cpu, card = outs
    assert torch.equal(cpu[4], card[4].cpu()) and torch.equal(cpu[5],
                                                              card[5].cpu())
    assert float((cpu[0] - card[0].cpu()).abs().max()) <= 1e-8


def test_nuts_chains_read_the_host_once_per_doubling(cuda):
    """``nuts_chains`` of 4 GP chains (10 warmup transitions, 10 draws) on
    the card under torch.cuda.set_sync_debug_mode("warn"): the
    synchronisations counted equal the lock-step doublings, one each."""
    import warnings

    lp, u0 = _gp_chains(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = gpt.nuts_chains(lp, u0, gen, num_samples=10, num_warmup=10,
                                  max_depth=6)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum(str(w.message).startswith(
        "called a synchronizing CUDA operation") for w in caught)
    assert res.doublings >= 20 and syncs == res.doublings
    assert bool(torch.isfinite(res.log_probs).all())


# --- the multi-GPU slice on one card ---------------------------------------

@pytest.fixture(scope="module")
def two_ranks_on_card():
    """2 gloo ranks sharing the card (``parallel.meshes.launch``), each
    running ``torch_parallel_ranks.card_cases``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import torch_parallel_ranks
    from gaussianprocessfundamentals_tpu_torch.parallel.meshes import launch

    cuda_gram._lib()
    cuda_dense_gram._lib()  # built here, loaded by the ranks
    return launch(torch_parallel_ranks.card_cases, 2, backend="gloo",
                  device="cuda", timeout=300)


def test_mesh_gram_matvec_on_two_gloo_ranks_matches_k1(cuda, two_ranks_on_card):
    """Each rank's panel through K1, then the all-gather: the single-process
    K1 product, within K3_RTOL (5e-5) of max|ref|."""
    import torch_parallel_ranks

    x, V, k = torch_parallel_ranks.card_inputs()
    ref = cuda_gram.fused_matvec_for(k, x)(V).cpu()
    for r in two_ranks_on_card:
        assert r["backend"] == "gloo" and r["jax_free"]
        assert r["k1"] == 1
        assert float((r["mv"] - ref).abs().max()) <= 5e-5 * float(
            ref.abs().max())


def test_cyclic_k5_block_rows_carry_the_noise_on_the_global_diagonal(
        cuda, two_ranks_on_card):
    """The ranks' cyclic block-rows built by K5 (one launch each) with
    σ² + jitter at each block-row's own columns equal the rows of the
    square build with it on its diagonal (2e-5·max|ref|)."""
    import torch_parallel_ranks as tpr
    from gaussianprocessfundamentals_tpu_torch.parallel.block_cholesky import (
        to_cyclic_blocks,
    )

    x, _, k = tpr.card_inputs()
    xs = x[:tpr.CARD_N_BC]
    ref = to_cyclic_blocks(cuda_dense_gram.dense_gram_for(
        k, xs, xs, tpr.CARD_DIAG), tpr.CARD_BLOCK, 2).cpu()
    for r in two_ranks_on_card:
        assert r["k5"] == 1
        assert float((r["panel"] - ref).abs().max()) <= 2e-5 * float(
            ref.abs().max())


def test_nccl_refuses_two_ranks_on_one_card(cuda):
    from gaussianprocessfundamentals_tpu_torch.parallel import meshes

    too_many = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="NCCL takes one rank per GPU"):
        meshes.launch(meshes.check_backend, too_many, backend="nccl",
                      device="cuda")
