"""ChangePoint (all three gates), Partition (both partitioning models), the
four new means and the mean operators, against the JAX package in float64.

Both packages get the same inputs (numpy, seeded), the same AST (the JAX
package's ``to_dict`` JSON) and the same hyperparameters (installed in the
port with ``params_from_numpy``): Grams, diagonals and means to 1e-10;
defaults, bounds, positivity, ``x_rescale``, ``prune`` and
``canonical_str`` to 1e-10 or exactly. Checkpoints load across packages;
a MeanChangePoint checkpoint is a round trip in the port only, because the
JAX package cannot write its gate to JSON.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.kernels.partition import (
    BoxPartitioning as JBox,
)
from gaussianprocessfundamentals_tpu.kernels.partition import (
    DistancePartitioning as JDist,
)
from gaussianprocessfundamentals_tpu.kernels.partition import (
    Partition as JPartition,
)
from gaussianprocessfundamentals_tpu.utils import checkpoint as jax_ckpt
from gaussianprocessfundamentals_tpu_torch.ops import expr
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)

GATES = ["indicator", "sigmoid", "approx_indicator"]
XR = [[0.0, 1.0], [-1.0, 2.0]]


def _np(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v), tree)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, path + (i,)).items()}
    return {path: np.asarray(tree, dtype=np.float64)}


def _close(got, ref, tol=1e-10):
    g, r = _flat(got), _flat(ref)
    assert set(g) == set(r)
    for k in r:
        np.testing.assert_allclose(g[k], r[k], rtol=tol, atol=tol,
                                   err_msg=str(k))


def _twin(jk, jp):
    tk = gpt.kernel_from_dict(json.loads(json.dumps(jk.to_dict())))
    gpt.params_from_numpy(tk, _np(jp), dtype=torch.float64)
    return tk


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-0.2, 1.2, (41, 2))
    x2 = rng.uniform(-0.2, 1.2, (29, 2))
    x1[:3, 0] = [0.3, 0.6, 0.6]  # points on the change points themselves
    return x1, x2


def _cp(gate, pkg=gpf):
    children = (pkg.SquaredExponentialKernel(dim=2, scaled=True),
                pkg.PeriodicKernel(dim=2),
                pkg.Matern52Kernel(dim=2, scaled=True))
    return pkg.ChangePoint(children=children,
                           gate=gpf.ChangePointGate(gate) if pkg is gpf
                           else gpt.ChangePointGate(gate))


def _jax_cp_params(jk):
    jp = jk.init_params(XR, 60, dtype=jnp.float64)
    jp["locations"] = jnp.asarray([0.6, 0.3])  # unsorted: sorted at use
    return jp


def _check_gram_diag(jk, jp, tk):
    x1, x2 = _inputs()
    for a, b in ((x1, x2), (x1, x1)):
        ref = np.asarray(jk.gram(jp, jnp.asarray(a), jnp.asarray(b)))
        got = tk.gram(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(tk.diag(torch.from_numpy(x1)).numpy(),
                               np.asarray(jk.diag(jp, jnp.asarray(x1))),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("gate", GATES)
def test_changepoint_gram_and_diag_match_jax(gate):
    jk = _cp(gate)
    jp = _jax_cp_params(jk)
    tk = _twin(jk, jp)
    assert tk.gate is gpt.ChangePointGate(gate)
    _check_gram_diag(jk, jp, tk)
    w = gpt.kernels.operators.changepoint_weights(
        torch.from_numpy(_inputs()[0]),
        torch.tensor([0.3, 0.6], dtype=torch.float64), tk.gate)
    from gaussianprocessfundamentals_tpu.kernels.operators import (
        changepoint_weights,
    )
    ref = changepoint_weights(jnp.asarray(_inputs()[0]),
                              jnp.asarray([0.3, 0.6]), jk.gate)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("gate", GATES)
def test_changepoint_params_prune_and_strings_match_jax(gate):
    jk = _cp(gate)
    tk = _twin(jk, _jax_cp_params(jk))
    _close(tk.init_params(XR, 60, dtype=torch.float64),
           jk.init_params(XR, 60, dtype=jnp.float64))
    _close(tk.positivity(), jk.positivity(), 0)
    for t, j in zip(tk.bounds(XR, 60), jk.bounds(XR, 60)):
        _close(t, j)
    jp = _jax_cp_params(jk)
    shift, scale = np.array([2.0, -1.0]), np.array([3.0, 0.5])
    _close(tk.x_rescale(gpt.tree_from_numpy(_np(jp), dtype=torch.float64),
                        torch.from_numpy(shift), torch.from_numpy(scale)),
           jk.x_rescale(jp, jnp.asarray(shift), jnp.asarray(scale)))
    assert tk.canonical_str() == jk.canonical_str()
    assert str(tk) == str(jk)
    # prune: one location outside the range, one overtaken, one kept
    jp["locations"] = jnp.asarray([0.4, 1.7, 0.4 + 1e-12])
    jk4 = jk.with_kernel_appended(gpf.LinearKernel(dim=2))
    jp["children"] = jp["children"] + (
        gpf.LinearKernel(dim=2).init_params(XR, 60, dtype=jnp.float64),)
    tk4 = _twin(jk4, jp)
    jpruned, jpp = jk4.prune(jp, XR)
    tpruned = tk4.prune(XR)
    assert tpruned.to_dict() == jpruned.to_dict()
    _close(tpruned.get_params(), jpp)
    # no change point inside the range: the first child itself
    jp["locations"] = jnp.asarray([-3.0, 5.0, 7.0])
    tk4.set_params(gpt.tree_from_numpy(_np(jp), dtype=torch.float64))
    assert tk4.prune(XR) is tk4.terms[0]
    assert (tk.with_kernel_prepended(gpt.LinearKernel()).to_dict()
            == jk.with_kernel_prepended(gpf.LinearKernel()).to_dict())


def _partitions():
    box = (JBox(edges=(0.25, 0.7), dim=1),
           gpt.BoxPartitioning(edges=(0.25, 0.7), dim=1))
    dist = (JDist(centers=((0.0, 0.0), (1.0, 0.5), (0.5, 1.0)), ignored_dims=()),
            gpt.DistancePartitioning(centers=((0.0, 0.0), (1.0, 0.5),
                                              (0.5, 1.0))))
    dist1 = (JDist(centers=((0.2, 9.0), (0.8, -9.0)), ignored_dims=(1,)),
             gpt.DistancePartitioning(centers=((0.2, 9.0), (0.8, -9.0)),
                                      ignored_dims=(1,)))
    return {"box": box, "distance": dist, "distance-ignored": dist1}


@pytest.mark.parametrize("name", ["box", "distance", "distance-ignored"])
def test_partition_matches_jax(name):
    jm, tm = _partitions()[name]
    x1, x2 = _inputs(2)
    x1[:2] = [[0.5, 0.25], [0.5, 0.5]]  # on an edge; equidistant (0.5, 0.5)
    np.testing.assert_array_equal(tm.assign(torch.from_numpy(x1)).numpy(),
                                  np.asarray(jm.assign(jnp.asarray(x1))))
    P = jm.num_partitions()
    leaves = [gpf.SquaredExponentialKernel(dim=2, scaled=True),
              gpf.Matern32Kernel(dim=2), gpf.LinearKernel(dim=2)][:P]
    jk = JPartition(children=tuple(leaves), model=jm)
    jp = jk.init_params(XR, 50, dtype=jnp.float64)
    tk = _twin(jk, jp)
    assert tk.model == tm
    _check_gram_diag(jk, jp, tk)
    assert tk.canonical_str() == jk.canonical_str() and str(tk) == str(jk)
    _close(tk.init_params(XR, 50, dtype=torch.float64), jp)
    _close(tk.positivity(), jk.positivity(), 0)
    for t, j in zip(tk.bounds(XR, 50), jk.bounds(XR, 50)):
        _close(t, j)
    shift, scale = np.array([1.0, -2.0]), np.array([0.5, 4.0])
    _close(tk.x_rescale(tk.get_params(), torch.from_numpy(shift),
                        torch.from_numpy(scale)),
           jk.x_rescale(jp, jnp.asarray(shift), jnp.asarray(scale)))


def test_asts_and_checkpoints_both_ways(tmp_path):
    jcp = _cp("sigmoid")
    jpart = JPartition(children=(gpf.SquaredExponentialKernel(dim=2),
                                 jcp), model=JBox(edges=(0.4,), dim=1))
    jp = jpart.init_params(XR, 50, dtype=jnp.float64)
    jp["children"][1]["locations"] = jnp.asarray([0.55, 0.35])
    tk = gpt.kernel_from_dict(jpart.to_dict())
    assert (json.loads(json.dumps(tk.to_dict()))
            == json.loads(json.dumps(jpart.to_dict())))
    assert gpf.kernel_from_dict(json.loads(json.dumps(tk.to_dict()))) == jpart
    # a JAX checkpoint loads in the port ...
    jax_ckpt.save(str(tmp_path / "j"), jpart, jp, noise=0.1)
    tk, _, noise = gpt.load(str(tmp_path / "j"), dtype=torch.float64)
    _close(tk.get_params(), jp)
    x1, x2 = _inputs(4)
    np.testing.assert_allclose(
        tk.gram(torch.from_numpy(x1), torch.from_numpy(x2)).numpy(),
        np.asarray(jpart.gram(jp, jnp.asarray(x1), jnp.asarray(x2))),
        rtol=1e-10, atol=1e-12)
    # ... and a port checkpoint in the JAX package
    gpt.save(str(tmp_path / "t"), tk, noise=noise)
    jk2, jp2, _, _, _ = jax_ckpt.load(str(tmp_path / "t"))
    assert jk2 == jpart
    _close(tk.get_params(), jp2)


MEANS = {
    "exp": lambda pkg: pkg.ExponentialMean(dim=2),
    "logit": lambda pkg: pkg.LogitMean(dim=2),
    "product": lambda pkg: (pkg.ConstantMean(dim=2) * pkg.LinearMean(dim=2)
                            * pkg.ExponentialMean(dim=2)),
    "sum-of-products": lambda pkg: (pkg.LogitMean(dim=2) * pkg.ConstantMean(dim=2)
                                    + pkg.LinearMean(dim=2)),
}


def _mean_params(jm, seed):
    """The JAX defaults, each leaf moved off them by a seeded amount."""
    rng = np.random.default_rng(seed)
    p = jm.init_params(XR, 30, dtype=jnp.float64)
    return jax.tree_util.tree_map(
        lambda v: jnp.asarray(np.asarray(v) * (1 + 0.3 * rng.uniform(
            -1, 1, np.shape(v)))), p)


@pytest.mark.parametrize("name", list(MEANS))
def test_means_match_jax(name):
    jm = MEANS[name](gpf)
    tm = gpt.mean_from_dict(json.loads(json.dumps(jm.to_dict())))
    assert tm.to_dict() == json.loads(json.dumps(jm.to_dict()))
    assert MEANS[name](gpt).to_dict() == tm.to_dict()  # `*` flattens alike
    _close(tm.init_params(XR, 30, dtype=torch.float64),
           jm.init_params(XR, 30, dtype=jnp.float64))
    _close(tm.positivity(), jm.positivity(), 0)
    jp = _mean_params(jm, 1)
    gpt.params_from_numpy(tm, _np(jp), dtype=torch.float64)
    x = _inputs(5)[0]
    np.testing.assert_allclose(tm.mean(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.mean(jp, jnp.asarray(x))),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("gate", GATES)
def test_mean_changepoint_matches_jax_and_round_trips(gate, tmp_path):
    from gaussianprocessfundamentals_tpu.means.functions import (
        MeanChangePoint as JMCP,
    )

    jm = JMCP(dim=2, children=(gpf.ConstantMean(dim=2), gpf.LinearMean(dim=2),
                               gpf.ConstantMean(dim=2)),
              gate=gpf.ChangePointGate(gate))
    tm = gpt.MeanChangePoint(children=(gpt.ConstantMean(dim=2),
                                       gpt.LinearMean(dim=2),
                                       gpt.ConstantMean(dim=2)),
                             dim=2, gate=gate)
    _close(tm.init_params(XR, 30, dtype=torch.float64),
           jm.init_params(XR, 30, dtype=jnp.float64))
    _close(tm.positivity(), jm.positivity(), 0)
    jp = _mean_params(jm, 2)
    jp["locations"] = jnp.asarray([0.7, 0.2])
    gpt.params_from_numpy(tm, _np(jp), dtype=torch.float64)
    x = _inputs(6)[0]
    np.testing.assert_allclose(tm.mean(torch.from_numpy(x)).numpy(),
                               np.asarray(jm.mean(jp, jnp.asarray(x))),
                               rtol=1e-10, atol=1e-12)
    # the gate goes to JSON as its string and comes back as the enum
    assert tm.to_dict()["gate"] == gate
    k = gpt.SquaredExponentialKernel(dim=2).set_params(
        {"lengthscale": torch.tensor(0.3, dtype=torch.float64)})
    gpt.save(str(tmp_path / "m"), k, tm, noise=0.01)
    _, tm2, _ = gpt.load(str(tmp_path / "m"), dtype=torch.float64)
    assert tm2.gate is gpt.ChangePointGate(gate)
    assert tm2.to_dict() == tm.to_dict()
    torch.testing.assert_close(tm2.mean(torch.from_numpy(x)),
                               tm.mean(torch.from_numpy(x)), rtol=0, atol=0)


def test_expression_kernels_refuse_the_new_operators_by_name():
    """K3/K4 cover Sum and Product only: the coverage check names
    ChangePoint and Partition as operators it does not evaluate."""
    cp = gpt.ChangePoint(children=(gpt.SquaredExponentialKernel(),
                                   gpt.SquaredExponentialKernel()))
    part = gpt.Partition(children=(gpt.SquaredExponentialKernel(),
                                   gpt.SquaredExponentialKernel()),
                         model=gpt.BoxPartitioning(edges=(0.5,)))
    for kernel, name in ((cp, "ChangePoint"), (part, "Partition")):
        for k in (kernel, kernel + gpt.LinearKernel()):
            why = expr.unsupported(k, 1)
            assert why is not None and why.startswith(f"{name} is an operator")
