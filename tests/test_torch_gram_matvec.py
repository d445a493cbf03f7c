"""The Gram·V product of the PyTorch port (K1's module) against the JAX
package's Pallas kernel, run in interpret mode as the JAX tests run it.

On the CPU the port's wrapper takes its plain row-panel version; the CUDA
kernel itself is checked on the card (``test_torch_cuda.py`` and
``chip_smoke.py``). The tolerances are the on-chip gates of
``benchmarks/check_pallas_tpu.py``: ``fused_matvec_cross_se`` (5e-5 of
max|ref|) at d = 1 and ``fused_matvec_se_d3`` (5e-4) at d = 3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.ops.pallas_gram import (
    fused_gram_matvec_cross as jax_fused_gram_matvec_cross,
)
from gaussianprocessfundamentals_tpu_torch.ops import cuda_gram
from gaussianprocessfundamentals_tpu_torch.ops.gram_matvec import (
    streamed_gram_matvec,
)
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# The suite runs one pytest-xdist worker per core: torch's own thread pool
# on top of that oversubscribes the CPU and slows every worker.
torch.set_num_threads(1)

CASES = [("se", 1, 0.15, 1.3, 5e-5), ("mat32", 1, 0.2, 0.7, 5e-5),
         ("mat52", 1, 0.2, 0.7, 5e-5), ("se", 3, 0.5, 1.3, 5e-4)]


@pytest.mark.parametrize("kind,d,ls,var,rtol", CASES)
@pytest.mark.parametrize("r", [1, 9, 130])
def test_plain_k1_matches_pallas_interpret(kind, d, ls, var, rtol, r):
    rng = np.random.default_rng(3)
    # ragged: neither n1 nor n2 is a multiple of the TPU's 512 tiles
    x1 = rng.uniform(0, 1, (700, d)).astype(np.float32)
    x2 = rng.uniform(0, 1, (1100, d)).astype(np.float32)
    V = rng.standard_normal((1100, r)).astype(np.float32)
    ref = np.asarray(jax_fused_gram_matvec_cross(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(V), ls, var,
        kind=kind, interpret=True,
    ))
    cuda_gram.fused_gram_matvec_cross.launches = 0
    got = cuda_gram.fused_gram_matvec_cross(
        torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(V),
        ls, var, kind,
    )
    assert got.dtype == torch.float32 and got.shape == (700, r)
    err = np.max(np.abs(got.numpy() - ref))
    assert err <= rtol * np.max(np.abs(ref)), err
    # CPU tensors take the plain version: nothing was launched
    assert cuda_gram.fused_gram_matvec_cross.launches == 0


def test_vector_V_and_square_form():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 1, (300, 1)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    out = cuda_gram.fused_gram_matvec(x, v, 0.2, 1.0, "se")
    assert out.shape == (300,)
    full = cuda_gram.fused_gram_matvec(x, v[:, None], 0.2, 1.0, "se")
    torch.testing.assert_close(out, full[:, 0])


@pytest.mark.parametrize("name,d", [("SquaredExponentialKernel", 2),
                                    ("Matern52Kernel", 1),
                                    ("Matern32Kernel", 3)])
def test_router_on_cpu_is_the_plain_panel_product(name, d):
    rng = np.random.default_rng(5)
    k = getattr(gpt, name)(dim=d, scaled=True)
    k.set_params({"lengthscale": torch.tensor(0.3, dtype=torch.float64),
                  "variance": torch.tensor(1.4, dtype=torch.float64)})
    x = torch.from_numpy(rng.uniform(0, 1, (257, d)))
    V = torch.from_numpy(rng.standard_normal((257, 4)))
    cuda_gram.fused_gram_matvec_cross.launches = 0
    got = cuda_gram.fused_matvec_for(k, x)(V)
    torch.testing.assert_close(got, k.gram(x, x) @ V, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(
        streamed_gram_matvec(k, x, V, block=64), k.gram(x, x) @ V,
        rtol=1e-12, atol=1e-12,
    )
    assert cuda_gram.fused_gram_matvec_cross.launches == 0


def test_k1_coverage():
    se = gpt.SquaredExponentialKernel(dim=3)
    se.set_params({"lengthscale": torch.tensor([0.1, 0.2, 0.3])})
    m52 = gpt.Matern52Kernel(dim=2)
    m52.set_params({"lengthscale": torch.tensor(0.2)})
    assert cuda_gram._k1_kind(se, 3) == "se"
    assert cuda_gram._k1_kind(m52, 1) == "mat52"
    assert cuda_gram._k1_kind(m52, 2) is None


def test_wrapper_rejects_tensors_off_cpu_and_cuda():
    x = torch.zeros(4, 1, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_gram.fused_gram_matvec_cross(x, x, torch.zeros(4, 1, device="meta"),
                                          0.1, 1.0, "se")
    with pytest.raises(ValueError, match="kind"):
        cuda_gram.fused_gram_matvec_cross(x, x, x, 0.1, 1.0, "rq")


def _pair_of(jk, jp):
    """The JAX kernel and parameters, and the port's kernel with them
    installed (float64)."""
    import jax

    tk = gpt.kernel_from_dict(jk.to_dict())
    gpt.params_from_numpy(tk, jax.tree_util.tree_map(np.asarray, jp),
                          dtype=torch.float64)
    return tk


def _sym_kernels(x):
    import gaussianprocessfundamentals_tpu as gpf

    se = gpf.SquaredExponentialKernel(scaled=True)
    se_p = {"lengthscale": jnp.asarray(0.1), "variance": jnp.asarray(1.3)}
    comp = (gpf.SquaredExponentialKernel(scaled=True) * gpf.PeriodicKernel()
            + gpf.LinearKernel())
    xr = np.stack([x.min(0), x.max(0)], -1)
    return {"se": (se, se_p), "composite": (comp, comp.init_params(xr, len(x)))}


@pytest.mark.parametrize("name", ["se", "composite"])
@pytest.mark.parametrize("block", [128, 256])
def test_symmetric_tile_matvec_matches_jax_and_the_row_panels(name, block):
    """``streamed_gram_matvec_symmetric`` at n = 700 (the last tile
    zero-padded for both blocks), float64, against the JAX package's and
    against the port's row-panel ``streamed_gram_matvec``: 1e-10 absolute,
    as ``tests/test_iterative.py``'s symmetric test holds the JAX one."""
    from gaussianprocessfundamentals_tpu.ops import gram_matvec as jgm
    from gaussianprocessfundamentals_tpu_torch.ops.gram_matvec import (
        streamed_gram_matvec_symmetric,
    )

    rng = np.random.default_rng(6)
    x = np.sort(rng.uniform(0, 1, (700, 1)), 0)
    V = rng.standard_normal((700, 5))
    jk, jp = _sym_kernels(x)[name]
    tk = _pair_of(jk, jp)
    ref = np.asarray(jgm.streamed_gram_matvec_symmetric(
        jk, jp, jnp.asarray(x), jnp.asarray(V), block))
    xt, Vt = torch.from_numpy(x), torch.from_numpy(V)
    got = streamed_gram_matvec_symmetric(tk, xt, Vt, block)
    assert got.shape == (700, 5) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(
        got.numpy(), streamed_gram_matvec(tk, xt, Vt, block).numpy(),
        rtol=0, atol=1e-10)
    # a vector V gives the first column
    np.testing.assert_allclose(
        streamed_gram_matvec_symmetric(tk, xt, Vt[:, 0], block).numpy(),
        got[:, 0].numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["se", "composite"])
def test_gram_diag_sum_matches_jax(name):
    from gaussianprocessfundamentals_tpu.ops import gram_matvec as jgm
    from gaussianprocessfundamentals_tpu_torch.ops.gram_matvec import (
        gram_diag_sum,
    )

    x = np.sort(np.random.default_rng(7).uniform(0, 1, (300, 1)), 0)
    jk, jp = _sym_kernels(x)[name]
    tk = _pair_of(jk, jp)
    ref = float(jgm.gram_diag_sum(jk, jp, jnp.asarray(x)))
    got = gram_diag_sum(tk, torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), ref, rtol=1e-12)
