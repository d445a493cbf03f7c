"""The launcher and the routers of the multi-GPU slice: a rank that raises
or hangs fails the launch (within its time limit) instead of blocking the
others; NCCL with more ranks than GPUs, or without CUDA, is refused; the
``gram_matvec`` routers equal the JAX package's; ``fit_iterative`` refuses
restarts under a mesh, as the JAX package does."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessfundamentals_tpu_torch.models import iterative
from gaussianprocessfundamentals_tpu_torch.parallel import meshes

import torch_parallel_ranks as ranks
from torch_parallel_jax import N, close, data, kernels, spec
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)


def test_gram_matvec_routers_match_jax():
    from gaussianprocessfundamentals_tpu.ops import gram_matvec as jgm
    from gaussianprocessfundamentals_tpu_torch.ops import gram_matvec as tgm

    x, _ = data()
    V = np.random.default_rng(3).standard_normal((N, 2))
    for jk, jp in kernels().values():
        tk = ranks.kernel_of(spec(jk, jp))
        xt = torch.from_numpy(x)
        close(tgm.gram_matvec(tk, xt, torch.from_numpy(V), 16),
               jgm.gram_matvec(jk, jp, jnp.asarray(x), jnp.asarray(V), 16),
               1e-10, "gram_matvec")
        close(tgm.gram_matvec_cross(tk, xt[:30], xt, torch.from_numpy(V)),
               jgm.gram_matvec_cross(jk, jp, jnp.asarray(x[:30]),
                                     jnp.asarray(x), jnp.asarray(V)),
               1e-10, "gram_matvec_cross")


def test_fit_iterative_refuses_restarts_under_a_mesh():
    with pytest.raises(ValueError, match="restarts"):
        iterative.fit_iterative(None, torch.zeros(4, 1), torch.zeros(4),
                                restarts=1, mesh=object())


def test_nccl_with_more_ranks_than_gpus_raises():
    with pytest.raises((ValueError, RuntimeError)):
        meshes.check_backend("nccl", "cuda", torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="nccl"):
        meshes.check_backend("nccl", "cpu", 1)
    with pytest.raises(ValueError):
        meshes.check_backend("mpi", "cpu", 1)


def test_launch_reports_a_failing_rank_and_a_hung_one(tmp_path):
    with pytest.raises(RuntimeError, match="rank one fails"):
        meshes.launch(ranks.raise_on_rank_one, 2, device="cpu", timeout=60,
                      init_method=f"file://{tmp_path}/a", threads=1)
    with pytest.raises(TimeoutError):
        meshes.launch(ranks.hang_on_rank_one, 2, device="cpu", timeout=5,
                      init_method=f"file://{tmp_path}/b", threads=1)
