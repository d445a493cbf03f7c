"""The JAX side of the multi-GPU parity tests
(``tests/test_torch_parallel*.py``): shared data, kernels, probes, the
comparisons and the one spawn per world size. Imports JAX, so spawned
ranks never import it (they run ``torch_parallel_ranks``)."""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import torch
from jax.sharding import Mesh

import gaussianprocessfundamentals_tpu as gpf
from gaussianprocessfundamentals_tpu.models import iterative as jit_
from gaussianprocessfundamentals_tpu_torch.models import iterative
from gaussianprocessfundamentals_tpu_torch.parallel import meshes

import torch_parallel_ranks as ranks

N = 101
N_DIV = 100  # divisible by 2 and 4, for the JAX cases that need it
NOISE = 0.05
S = 4  # probes
SPAWN_TIMEOUT = 120.0


def close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= tol * scale, (what, err, tol * scale)


def close_tree(got, ref, tol, what=""):
    ref_leaves = jax.tree_util.tree_leaves(ref)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(ref_leaves), what
    for g, r in zip(got_leaves, ref_leaves):
        close(g, r, tol, what)


def jmesh(P, axis="tp"):
    return Mesh(np.array(jax.devices()[:P]), (axis,))


def data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1, (n, 1)), 0)
    y = np.sin(6 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    return x, y


def kernels():
    """(name, JAX kernel, JAX params): an SE leaf and a composite."""
    se = gpf.SquaredExponentialKernel(scaled=True)
    se_p = {"lengthscale": jnp.asarray(0.2), "variance": jnp.asarray(1.3)}
    comp = gpf.SquaredExponentialKernel(scaled=True) + gpf.Matern52Kernel()
    comp_p = {"children": ({"lengthscale": jnp.asarray(0.15),
                            "variance": jnp.asarray(0.8)},
                           {"lengthscale": jnp.asarray(0.4)})}
    return {"se": (se, se_p), "composite": (comp, comp_p)}


def spec(jk, jp):
    return {"dict": jk.to_dict(),
            "params": jax.tree_util.tree_map(np.asarray, jp)}


def jax_probes(key, n, s, m):
    key_u, key_w = jr.split(key)
    if m == 0:
        return np.array(jr.rademacher(key_u, (n, s)).astype(jnp.float64)), None
    return (np.array(jr.normal(key_u, (n, s), jnp.float64)),
            np.array(jr.normal(key_w, (m, s), jnp.float64)))


def port_w(jk, jp, x, m, w):
    """w in the port's preconditioner basis (``test_torch_fit.port_w``)."""
    _, Wj, svj, _, _ = jit_.build_preconditioner(jk, jp, jnp.asarray(x), m,
                                                 NOISE)
    tk = ranks.kernel_of(spec(jk, jp))
    _, Wp, svp, _, _ = iterative.build_preconditioner(tk, torch.from_numpy(x),
                                                      m, NOISE)
    a = Wp.numpy().T @ (np.asarray(Wj) @ (np.asarray(svj)[:, None] * w))
    svp = svp.numpy()[:, None]
    return np.where(svp > 0, a / np.where(svp > 0, svp, 1.0), 0.0)




def spawn(tmp_path_factory, cases_by_world: dict) -> dict:
    """world size → every rank's results of its cases: one spawn of gloo
    ranks on the CPU per world size, one torch thread each, a ``file://``
    rendezvous of its own, and a time limit on every collective and on
    the join, so a hung rank fails its tests and not the suite."""
    out = {}
    for P, cases in cases_by_world.items():
        rdv = tmp_path_factory.mktemp(f"rdv{P}") / "pg"
        out[P] = meshes.launch(ranks.run_cases, P, (cases,), backend="gloo",
                               device="cpu", timeout=SPAWN_TIMEOUT,
                               init_method=f"file://{rdv}", threads=1)
    return out
