"""The low-rank-cotangent gradient of the PyTorch port (K2's module) against
the JAX package: the streamed autograd version against the JAX streamed VJP
in float64, and the kernel's wrapper (its plain version on the CPU) against
the JAX Pallas kernel run in interpret mode, in float32.

Tolerances: 1e-8 relative in float64 (the two packages differ only in the
order of their sums and in XLA's CPU ``exp``, which is float32-accurate);
1e-3 relative per scalar in float32, the on-chip gate ``fused_lrvjp_*`` of
``benchmarks/check_pallas_tpu.py``. The cotangents have a non-zero mean, so
the two sums do not cancel to round-off and a relative error means
something.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.ops.gram_matvec import (
    lowrank_gram_vjp_cross as jax_lowrank_gram_vjp_cross,
)
from gaussianprocessfundamentals_tpu.ops.pallas_gram import (
    fused_lowrank_vjp_cross as jax_fused_lowrank_vjp_cross,
)
from gaussianprocessfundamentals_tpu.ops.pallas_gram import (
    fused_lowrank_vjp_cross_for as jax_fused_lowrank_vjp_cross_for,
)
from gaussianprocessfundamentals_tpu_torch.ops import cuda_lrvjp
from gaussianprocessfundamentals_tpu_torch.ops.gram_matvec import (
    lowrank_gram_vjp,
    lowrank_gram_vjp_cross,
)

# The suite runs one pytest-xdist worker per core: torch's own thread pool
# on top of that oversubscribes the CPU and slows every worker.
torch.set_num_threads(1)

CASES = [("SquaredExponentialKernel", "se", 1),
         ("SquaredExponentialKernel", "se", 3),
         ("SquaredExponentialKernel", "se", 20),
         ("Matern32Kernel", "mat32", 1),
         ("Matern52Kernel", "mat52", 1)]
LS, VAR = 0.3, 1.4


def _inputs(d, r, dtype, seed=0):
    """Ragged n1 ≠ n2 (neither a multiple of the TPU's 512 tiles)."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, 1, (600, d))
    x2 = rng.uniform(0, 1, (1100, d))
    U = 0.5 + rng.standard_normal((600, r))
    W = 0.5 + rng.standard_normal((1100, r))
    return [a.astype(dtype) for a in (x1, x2, U, W)]


def _pair(name, d, scaled, dtype):
    jk = getattr(gpf, name)(dim=d, scaled=scaled)
    jp = {"lengthscale": jnp.asarray(LS, dtype)}
    if scaled:
        jp["variance"] = jnp.asarray(VAR, dtype)
    tk = gpt.kernel_from_dict(jk.to_dict())
    gpt.params_from_numpy(tk, {k: np.asarray(v) for k, v in jp.items()})
    return jk, jp, tk


def _rel(got, ref):
    return abs(float(got) - float(ref)) / abs(float(ref))


@pytest.mark.parametrize("name,kind,d", CASES)
@pytest.mark.parametrize("scaled", [True, False])
def test_streamed_vjp_matches_jax_f64(name, kind, d, scaled):
    x1, x2, U, W = _inputs(d, 5, np.float64)
    jk, jp, tk = _pair(name, d, scaled, jnp.float64)
    ref = jax_lowrank_gram_vjp_cross(jk, jp, jnp.asarray(x1), jnp.asarray(x2),
                                     jnp.asarray(U), jnp.asarray(W), block=256)
    got = lowrank_gram_vjp_cross(tk, *map(torch.from_numpy, (x1, x2, U, W)),
                                 block=256)
    assert set(got) == set(jp)
    for p in jp:
        np.testing.assert_allclose(float(got[p]), float(ref[p]), rtol=1e-8,
                                   err_msg=p)
    # the modules' installed values are back, with no graph attached
    assert not tk.lengthscale.requires_grad
    assert float(tk.lengthscale) == LS


@pytest.mark.parametrize("name,kind,d", CASES)
@pytest.mark.parametrize("r", [1, 17])
def test_plain_k2_matches_pallas_interpret(name, kind, d, r):
    x1, x2, U, W = _inputs(d, r, np.float32, seed=1)
    ref = jax_fused_lowrank_vjp_cross(
        *map(jnp.asarray, (x1, x2, U, W)), LS, VAR, kind=kind, interpret=True)
    cuda_lrvjp.fused_lowrank_vjp_cross.launches = 0
    got = cuda_lrvjp.fused_lowrank_vjp_cross(
        *map(torch.from_numpy, (x1, x2, U, W)), LS, VAR, kind)
    for g, rf in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == ()
        assert _rel(g, rf) <= 1e-3, (float(g), float(rf))
    # CPU tensors take the plain version: nothing was launched
    assert cuda_lrvjp.fused_lowrank_vjp_cross.launches == 0


@pytest.mark.parametrize("name,kind,d", CASES)
@pytest.mark.parametrize("scaled", [True, False])
def test_router_matches_jax_router_f32(name, kind, d, scaled):
    """``fused_lowrank_vjp_cross_for`` gives the kernel's params dict; an
    unscaled kernel has no variance gradient, as in the JAX package."""
    x1, x2, U, W = _inputs(d, 9, np.float32, seed=2)
    jk, jp, tk = _pair(name, d, scaled, jnp.float32)
    ref = jax_fused_lowrank_vjp_cross_for(
        jk, jp, jnp.asarray(x1), jnp.asarray(x2), interpret=True,
    )(jnp.asarray(U), jnp.asarray(W))
    got = cuda_lrvjp.fused_lowrank_vjp_cross_for(
        tk, torch.from_numpy(x1), torch.from_numpy(x2),
    )(torch.from_numpy(U), torch.from_numpy(W))
    assert set(got) == set(ref) == set(jp)
    for p in jp:
        assert _rel(got[p], ref[p]) <= 1e-3, (p, float(got[p]), float(ref[p]))


def test_square_forms_and_plain_version_agree():
    x1, _, U, _ = _inputs(1, 4, np.float64, seed=3)
    W = np.random.default_rng(4).standard_normal(U.shape)
    x, U, W = map(torch.from_numpy, (x1, U, W))
    k = gpt.Matern52Kernel(scaled=True)
    k.set_params({"lengthscale": torch.tensor(LS, dtype=torch.float64),
                  "variance": torch.tensor(VAR, dtype=torch.float64)})
    g = lowrank_gram_vjp(k, x, U, W, block=128)
    g_ls, g_var = cuda_lrvjp.fused_lowrank_vjp(x, U, W, LS, VAR, "mat52")
    torch.testing.assert_close(g_ls, g["lengthscale"], rtol=1e-12, atol=0)
    torch.testing.assert_close(g_var, g["variance"], rtol=1e-12, atol=0)
    routed = cuda_lrvjp.fused_lowrank_vjp_for(k, x)(U, W)
    torch.testing.assert_close(routed["lengthscale"], g["lengthscale"])
    # against the dense contraction Σ(UWᵀ)∘K by autograd
    with k.differentiable() as p:
        total = torch.sum(k.gram(x, x) * (U @ W.T))
        dense = torch.autograd.grad(total, [p["lengthscale"], p["variance"]])
    torch.testing.assert_close(g["lengthscale"], dense[0], rtol=1e-10, atol=0)
    torch.testing.assert_close(g["variance"], dense[1], rtol=1e-10, atol=0)


def test_cotangent_factor_adds_zero_columns_to_a_multiple_of_4():
    """The NLL's factors: r = 273 becomes 276 by zero columns, which leave
    U·Wᵀ and so the gradient exactly as they were."""
    from gaussianprocessfundamentals_tpu_torch.models.iterative import (
        cotangent_factor,
    )

    x1, x2, U, W = (torch.from_numpy(a) for a in
                    _inputs(1, 273, np.float64, seed=4))
    Up = cotangent_factor([U[:, :200], U[:, 200:]])
    Wp = cotangent_factor([W[:, :1], W[:, 1:]])
    assert Up.shape == (600, 276) and Wp.shape == (1100, 276)
    assert torch.equal(Up[:, :273], U) and not Up[:, 273:].any()
    assert cotangent_factor([U[:, :272]]).shape[1] == 272
    k = gpt.SquaredExponentialKernel(scaled=True)
    k.set_params({"lengthscale": torch.tensor(LS, dtype=torch.float64),
                  "variance": torch.tensor(VAR, dtype=torch.float64)})
    got = lowrank_gram_vjp_cross(k, x1, x2, Up, Wp)
    ref = lowrank_gram_vjp_cross(k, x1, x2, U, W)
    for name in ("lengthscale", "variance"):
        torch.testing.assert_close(got[name], ref[name], rtol=1e-12, atol=0)


def test_k2_coverage():
    """The same predicate as the JAX package's ``_fused_kind_for``: scalar
    lengthscale SE at any d, Matérn at d = 1; ARD goes to K4."""
    se = gpt.SquaredExponentialKernel(dim=3)
    se.set_params({"lengthscale": torch.tensor(0.2)})
    ard = gpt.SquaredExponentialKernel(dim=3)
    ard.set_params({"lengthscale": torch.tensor([0.1, 0.2, 0.3])})
    m32 = gpt.Matern32Kernel(dim=2)
    m32.set_params({"lengthscale": torch.tensor(0.2)})
    assert cuda_lrvjp._k2_kind(se, 3) == "se"
    assert cuda_lrvjp._k2_kind(ard, 3) is None
    assert cuda_lrvjp._k2_kind(m32, 1) == "mat32"
    assert cuda_lrvjp._k2_kind(m32, 2) is None


def test_wrapper_rejects_tensors_off_cpu_and_cuda():
    x = torch.zeros(4, 1, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_lrvjp.fused_lowrank_vjp_cross(x, x, x, x, 0.1, 1.0, "se")
    with pytest.raises(ValueError, match="kind"):
        cuda_lrvjp.fused_lowrank_vjp_cross(x, x, x, x, 0.1, 1.0, "rq")
