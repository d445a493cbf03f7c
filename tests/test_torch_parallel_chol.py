"""The port's mesh paths against the JAX package's (3 of 5): the
block-cyclic distributed Cholesky (the factor through
``from_cyclic_blocks``, the diagonal blocks' inverses, both solves, the NLL
from K and from each rank's own block-rows, the exact posterior), and the
dry run over 4 ranks. See ``tests/test_torch_parallel.py`` for the layout.
n = 96 rows in blocks of 8 (the JAX package needs n a multiple of
block·P). Tolerance 1e-8 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianprocessfundamentals_tpu.parallel import block_cholesky as jbc
from gaussianprocessfundamentals_tpu_torch.parallel import block_cholesky as bc
from gaussianprocessfundamentals_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
)
from torch_parallel_jax import close, close_tree, data, jmesh, kernels, spawn, spec

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 virtual devices")

N_BC = 96
BLOCK = 8


def _chol_inputs():
    x, y = data(N_BC, seed=5)
    jk, jp = kernels()["se"]
    K = np.asarray(jk.gram(jp, jnp.asarray(x), jnp.asarray(x)))
    return {"kernel": spec(jk, jp), "x": x, "y": y, "K": K,
            "Y": np.random.default_rng(6).standard_normal((N_BC, 3)),
            "xt": np.linspace(0.02, 0.98, 9)[:, None], "block": BLOCK}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return spawn(tmp_path_factory, {
        P: {"block_cholesky": _chol_inputs()} for P in (2, 4)})


@pytest.mark.parametrize("P", [2, 4])
def test_block_cyclic_cholesky_and_solves_match_jax(port, P):
    c = _chol_inputs()
    mesh = jmesh(P)
    K = jnp.asarray(c["K"])
    Kn = K + 0.1 * jnp.eye(N_BC)
    y, Y = jnp.asarray(c["y"]), jnp.asarray(c["Y"])
    with mesh:
        L, logdet = jbc.distributed_cholesky(Kn, mesh, "tp", BLOCK)
        L2, Linv, logdet2 = jbc.distributed_cholesky_factor(Kn, mesh, "tp",
                                                            BLOCK)
        solve = jbc.distributed_chol_solve(L, y, mesh, "tp", BLOCK)
        solve_inv = jbc.distributed_chol_solve_inv(L2, Linv, Y, mesh, "tp",
                                                   BLOCK)
    dense = np.asarray(jbc.from_cyclic_blocks(L, P))
    np.testing.assert_allclose(dense, np.linalg.cholesky(np.asarray(Kn)),
                               atol=1e-10)
    for r in port[P]:
        got = r["block_cholesky"]
        L_port = bc.from_cyclic_blocks(torch.from_numpy(got["L"]), P)
        close(L_port, dense, 1e-8, "factor")
        close(got["logdet"], logdet, 1e-8, "logdet")
        close(got["logdet2"], logdet2, 1e-8, "logdet (factor)")
        close(got["Linv"], Linv, 1e-8, "Linv")
        close(got["solve"], solve, 1e-8, "solve")
        close(got["solve_inv"], solve_inv, 1e-8, "solve with Linv")
        close(got["panel"],
              jbc.to_cyclic_blocks(K + 0.1 * jnp.eye(N_BC), BLOCK, P), 1e-8,
              "cyclic block-rows with the noise on the global diagonal")


@pytest.mark.parametrize("P", [2, 4])
def test_distributed_nll_and_posterior_match_jax(port, P):
    c = _chol_inputs()
    jk, jp = kernels()["se"]
    mesh = jmesh(P)
    K, y = jnp.asarray(c["K"]), jnp.asarray(c["y"])
    with mesh:
        nll = jbc.distributed_nll(K, y, 0.1, 1e-6, mesh, block=BLOCK)
        nll_u = jbc.distributed_nll(K, y, 0.1, 1e-6, mesh, block=BLOCK,
                                    unroll=True)
        post = jbc.distributed_posterior(jk, jp, jnp.asarray(c["x"]), y,
                                         jnp.asarray(c["xt"]), 0.1, 1e-6,
                                         mesh, block=BLOCK)
    for r in port[P]:
        got = r["block_cholesky"]
        close(got["nll"], nll, 1e-8, "nll")
        close(got["nll_unroll"], nll_u, 1e-8, "nll (unroll)")
        close(got["nll_rows"], nll, 1e-8, "nll from the rank's block-rows")
        close_tree(got["posterior"], post, 1e-8, "posterior")


def test_dryrun_multichip_four_ranks(tmp_path):
    res = dryrun_multichip(4, init_method=f"file://{tmp_path}/pg")
    assert res["dp"] == 2 and res["tp"] == 2 and res["backend"] == "gloo"
    assert res["jax_free"]
