"""The PyTorch port's leaf kernels against the JAX package's, in float64.

Both packages get the same inputs (numpy, seeded) and the same kernel spec
(the AST JSON of ``to_dict``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.kernels.base import (
    kernel_from_dict as jax_kernel_from_dict,
)
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# The suite runs one pytest-xdist worker per core: torch's own thread pool
# on top of that oversubscribes the CPU and slows every worker.
torch.set_num_threads(1)

LEAVES = ["SquaredExponentialKernel", "Matern32Kernel", "Matern52Kernel"]


def _pair(name, d, scaled, ard, rng):
    """The same kernel in both packages, with the same hyperparameters."""
    jk = getattr(gpf, name)(dim=d, scaled=scaled)
    tk = gpt.kernel_from_dict(jk.to_dict())
    ls = rng.uniform(0.2, 0.6, (d,)) if ard else np.float64(rng.uniform(0.2, 0.6))
    params = {"lengthscale": ls}
    if scaled:
        params["variance"] = np.float64(rng.uniform(0.5, 2.0))
    gpt.params_from_numpy(tk, params, dtype=torch.float64)
    return jk, {k: jnp.asarray(v) for k, v in params.items()}, tk


@pytest.mark.parametrize("name", LEAVES)
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("ard", [False, True])
def test_gram_and_diag_match_jax(name, d, scaled, ard):
    rng = np.random.default_rng(7)
    jk, jp, tk = _pair(name, d, scaled, ard, rng)
    x1 = rng.uniform(-1.0, 2.0, (37, d))
    x2 = rng.uniform(-1.0, 2.0, (23, d))
    ref = np.asarray(jk.gram(jp, jnp.asarray(x1), jnp.asarray(x2)))
    got = tk.gram(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        tk.diag(torch.from_numpy(x1)).numpy(),
        np.asarray(jk.diag(jp, jnp.asarray(x1))), rtol=1e-12,
    )


@pytest.mark.parametrize("name", LEAVES)
@pytest.mark.parametrize("scaled", [False, True])
def test_ast_json_round_trip_across_packages(name, scaled):
    jk = getattr(gpf, name)(dim=2, scaled=scaled)
    tk = gpt.kernel_from_dict(jk.to_dict())
    assert tk.to_dict() == jk.to_dict()
    assert tk.canonical_str() == jk.canonical_str()
    assert str(tk) == str(jk)
    back = jax_kernel_from_dict(tk.to_dict())
    assert back == jk


@pytest.mark.parametrize("name", LEAVES)
@pytest.mark.parametrize("scaled", [False, True])
def test_defaults_bounds_positivity_match_jax(name, scaled):
    jk = getattr(gpf, name)(scaled=scaled)
    tk = gpt.kernel_from_dict(jk.to_dict())
    xr, n = [[-2.0, 3.0]], 500
    jp = jk.init_params(xr, n, dtype=jnp.float64)
    tp = tk.init_params(xr, n, dtype=torch.float64)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-15)
    assert tk.bounds(xr, n) == jk.bounds(xr, n)
    assert tk.positivity() == jk.positivity()
    gen = torch.Generator().manual_seed(0)
    lo, hi = tk.bounds(xr, n)
    for k, v in tk.init_params(xr, n, generator=gen, dtype=torch.float64).items():
        assert lo[k] <= float(v) <= hi[k]


def test_x_rescale_matches_jax():
    jk = gpf.SquaredExponentialKernel(scaled=True)
    tk = gpt.kernel_from_dict(jk.to_dict())
    p = {"lengthscale": 0.3, "variance": 1.7}
    ref = jk.x_rescale({k: jnp.asarray(v) for k, v in p.items()}, 1.5, 4.0)
    got = tk.x_rescale({k: torch.tensor(v, dtype=torch.float64)
                        for k, v in p.items()}, 1.5, 4.0)
    for k in p:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-15)


def test_unported_kernel_type_raises():
    """Every kernel type of the JAX package is ported; a type neither
    package has is refused by name."""
    from gaussianprocessfundamentals_tpu.kernels.base import KERNEL_REGISTRY

    assert set(KERNEL_REGISTRY) <= set(gpt.kernels.base.KERNEL_REGISTRY)
    with pytest.raises(NotImplementedError, match="'SpectralMixture' is not"):
        gpt.kernel_from_dict({"type": "SpectralMixture", "dim": 1})


def test_set_params_rejects_wrong_names():
    k = gpt.SquaredExponentialKernel(scaled=True)
    with pytest.raises(KeyError):
        k.set_params({"lengthscale": torch.tensor(0.1)})
    assert not k.has_params()


@pytest.mark.parametrize("fn", ["euclidean", "sq_manhattan"])
@pytest.mark.parametrize("d", [1, 3])
def test_distances_match_jax(fn, d):
    """``euclidean`` and ``sq_manhattan`` of ``ops/distances.py`` against
    the JAX package's at 1e-12 relative, float64; x1 shares rows with x2,
    so the guarded square root's zeros are among the values."""
    from gaussianprocessfundamentals_tpu.ops import distances as jdist
    from gaussianprocessfundamentals_tpu_torch.ops import distances as tdist

    rng = np.random.default_rng(11)
    x2 = rng.uniform(-1.0, 2.0, (23, d))
    x1 = np.concatenate([x2[:5], rng.uniform(-1.0, 2.0, (32, d))])
    ref = np.asarray(getattr(jdist, fn)(jnp.asarray(x1), jnp.asarray(x2)))
    got = getattr(tdist, fn)(torch.from_numpy(x1), torch.from_numpy(x2))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("repeated", [False, True])
def test_euclidean_gradient_on_the_diagonal_is_zero_as_in_jax(repeated):
    """The gradient of Σᵢⱼ |xᵢ − xⱼ| through ``euclidean(x, x)`` at d = 1,
    where d² is exactly 0 on the diagonal (and between repeated rows): the
    guarded root makes those entries' gradient 0, not inf or NaN, in both
    packages, and the gradients agree within 1e-12. (At d > 1 the
    |a|² − 2ab + |b|² expansion can leave a rounding residue of ~4e-16 on
    the diagonal in both packages, which the guard does not take.)"""
    import jax

    from gaussianprocessfundamentals_tpu.ops import distances as jdist
    from gaussianprocessfundamentals_tpu_torch.ops import distances as tdist

    x = np.random.default_rng(12).uniform(0.0, 1.0, (9, 1))
    if repeated:
        x = np.concatenate([x, x[:3]])
    jgrad = np.asarray(jax.grad(
        lambda a: jnp.sum(jdist.euclidean(a, a)))(jnp.asarray(x)))
    jdiag = np.asarray(jax.grad(
        lambda a: jnp.trace(jdist.euclidean(a, a)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    tdist.euclidean(xt, xt).sum().backward()
    xd = torch.from_numpy(x).requires_grad_()
    torch.diagonal(tdist.euclidean(xd, xd)).sum().backward()
    assert np.all(jdiag == 0.0) and torch.all(xd.grad == 0.0)
    assert np.all(np.isfinite(jgrad))
    np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=0, atol=1e-12)


def test_kernel_alias_and_default_dtype_match_jax():
    import jax

    from gaussianprocessfundamentals_tpu.config import (
        default_dtype as jax_default_dtype,
    )
    from gaussianprocessfundamentals_tpu.kernels.leaves import (
        KERNEL_ALIAS as JAX_ALIAS,
    )
    from gaussianprocessfundamentals_tpu_torch.config import default_dtype
    from gaussianprocessfundamentals_tpu_torch.kernels.leaves import (
        KERNEL_ALIAS,
    )

    assert {k: v.__name__ for k, v in KERNEL_ALIAS.items()} == {
        k: v.__name__ for k, v in JAX_ALIAS.items()}
    assert KERNEL_ALIAS["RBFKernel"] is gpt.RBFKernel
    assert jax.config.jax_enable_x64  # the suite runs the JAX side in x64
    assert str(jax_default_dtype().dtype) == "float64"
    old = torch.get_default_dtype()
    try:
        for dt in (torch.float64, torch.float32):
            torch.set_default_dtype(dt)
            assert default_dtype() is dt
            # unset dtypes of new hyperparameters follow it
            k = gpt.SquaredExponentialKernel()
            assert k.init_params(np.array([[0.0, 1.0]]), 10)[
                "lengthscale"].dtype is dt
    finally:
        torch.set_default_dtype(old)
