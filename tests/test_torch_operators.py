"""The PyTorch port's kernel grammar against the JAX package, in float64: the
constant, white-noise, linear, periodic and rational-quadratic leaves, and
Sum / Product trees of every leaf.

Both packages get the same inputs (numpy, seeded), the same kernel spec
(the AST JSON of ``to_dict``) and the same hyperparameters (the JAX
package's random draw inside the bounds, installed in the port with
``params_from_numpy``). Gram matrices and diagonals agree to 1e-12
relative; the defaults, bounds, positivity and x units exactly.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.kernels.base import (
    kernel_from_dict as jax_kernel_from_dict,
)
from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves

# The suite runs one pytest-xdist worker per core: torch's own thread pool
# on top of that oversubscribes the CPU and slows every worker.
torch.set_num_threads(1)

NEW_LEAVES = ["ConstantKernel", "WhiteNoiseKernel", "LinearKernel",
              "PeriodicKernel", "RationalQuadraticKernel"]


def _mauna(pkg):
    return (pkg.SquaredExponentialKernel(scaled=True) * pkg.PeriodicKernel()
            + pkg.SquaredExponentialKernel(scaled=True) + pkg.LinearKernel()
            + pkg.WhiteNoiseKernel(scaled=True))


EXPRESSIONS = {
    "mauna": _mauna,
    "rq+m32~s": lambda pkg: (pkg.RationalQuadraticKernel(dim=2)
                             + pkg.Matern32Kernel(dim=2, scaled=True)),
    "const*lin+wn": lambda pkg: (pkg.ConstantKernel() * pkg.LinearKernel(dim=2)
                                 + pkg.WhiteNoiseKernel()),
    "(se+per)*m52~s": lambda pkg: ((pkg.SquaredExponentialKernel()
                                    + pkg.PeriodicKernel())
                                   * pkg.Matern52Kernel(scaled=True)),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, path=()):
    """{path: numpy leaf} of a params tree of either package (dicts, with
    tuples under operators): JAX orders dict leaves by key, the port by
    parameter, so trees are compared by path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: np.asarray(tree)}


def _same(got, ref, rtol=0.0):
    g, r = _flat(got), _flat(ref)
    assert set(g) == set(r)
    for k in r:
        np.testing.assert_allclose(g[k], r[k], rtol=rtol, atol=0, err_msg=str(k))


def _pair(jk, d, n=50, seed=0, ard=False):
    """The JAX kernel, its random params inside the bounds, and the port's
    twin holding the same values. ``ard`` gives RQ a per-dimension ℓ."""
    xr = [[0.0, 1.0]] * d
    jp = jk.init_params(xr, n, key=jr.PRNGKey(seed), dtype=jnp.float64)
    if ard:
        jp = dict(jp, lengthscale=jnp.asarray(np.linspace(0.2, 0.4, d)))
    tk = gpt.kernel_from_dict(jk.to_dict())
    gpt.params_from_numpy(tk, _np(jp), dtype=torch.float64)
    return jp, tk


def _inputs(d, seed=1):
    """x1 [37, d], x2 [23, d]; x2 repeats five rows of x1 and one of its
    own, so WhiteNoise has coincident pairs in both blocks."""
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-0.5, 1.5, (37, d))
    x2 = rng.uniform(-0.5, 1.5, (23, d))
    x2[:5] = x1[[3, 8, 8, 20, 36]]
    x2[7] = x2[6]
    return x1, x2


def _check_gram_diag(jk, jp, tk, d):
    x1, x2 = _inputs(d)
    for a, b in ((x1, x2), (x1, x1), (x2, x2)):
        ref = np.asarray(jk.gram(jp, jnp.asarray(a), jnp.asarray(b)))
        got = tk.gram(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tk.diag(torch.from_numpy(x1)).numpy(),
                               np.asarray(jk.diag(jp, jnp.asarray(x1))),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", NEW_LEAVES + ["RQ-ARD"])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("scaled", [False, True])
def test_leaf_gram_and_diag_match_jax(name, d, scaled):
    ard = name == "RQ-ARD"
    jk = getattr(gpf, "RationalQuadraticKernel" if ard else name)(
        dim=d, scaled=scaled)
    jp, tk = _pair(jk, d, ard=ard)
    _check_gram_diag(jk, jp, tk, d)


@pytest.mark.parametrize("name", NEW_LEAVES)
@pytest.mark.parametrize("scaled", [False, True])
def test_leaf_defaults_bounds_positivity_x_units_match_jax(name, scaled):
    """Defaults, bounds and positivity exactly; ``x_rescale`` with LIN's
    affine offset and PER's unit-free lengthscale (only the period scales)
    to 1e-15; random draws inside the bounds."""
    jk = getattr(gpf, name)(dim=2, scaled=scaled)
    tk = gpt.kernel_from_dict(jk.to_dict())
    xr, n = [[-2.0, 3.0], [1.0, 4.0]], 500
    jp = jk.init_params(xr, n, dtype=jnp.float64)
    tp = tk.init_params(xr, n, dtype=torch.float64)
    assert set(tp) == set(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    jlo, jhi = jk.bounds(xr, n)
    tlo, thi = tk.bounds(xr, n)
    for j, t in ((jlo, tlo), (jhi, thi)):
        assert set(j) == set(t)
        for k in j:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]))
    assert tk.positivity() == jk.positivity()
    shift, scale = np.array([1.5, -0.5]), np.array([4.0, 2.0])
    ref = jk.x_rescale(jp, jnp.asarray(shift), jnp.asarray(scale))
    got = tk.x_rescale(tp, torch.from_numpy(shift), torch.from_numpy(scale))
    for k in jp:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-15)
    gen = torch.Generator().manual_seed(0)
    for k, v in tk.init_params(xr, n, generator=gen, dtype=torch.float64).items():
        assert np.all(np.asarray(tlo[k]) <= v.numpy())
        assert np.all(v.numpy() <= np.asarray(thi[k]))


@pytest.mark.parametrize("expr", list(EXPRESSIONS))
def test_operator_tree_matches_jax(expr):
    """Sum / Product of every leaf: gram, diag, init_params, positivity,
    bounds and x_rescale of the whole tree, nested like the JAX package's
    params tree."""
    jk = EXPRESSIONS[expr](gpf)
    d = 2 if "2" in str(jk.to_dict()) else 1
    jp, tk = _pair(jk, d, seed=3)
    _check_gram_diag(jk, jp, tk, d)
    xr, n = [[0.0, 2.0]] * d, 300
    _same(tk.init_params(xr, n, dtype=torch.float64),
          jk.init_params(xr, n, dtype=jnp.float64))
    assert tk.positivity() == jk.positivity()
    for t, j in zip(tk.bounds(xr, n), jk.bounds(xr, n)):
        _same(t, j)
    _same(tk.x_rescale(tk.get_params(), 0.5, 3.0), jk.x_rescale(jp, 0.5, 3.0),
          rtol=1e-15)


@pytest.mark.parametrize("expr", list(EXPRESSIONS))
def test_canonical_str_and_json_round_trip_across_packages(expr):
    """``+``/``*`` flatten as ``_merge`` does; ``str``, ``canonical_str``
    (sorted children) and the AST JSON are the JAX package's, and each
    package rebuilds the other's tree."""
    jk, tk = EXPRESSIONS[expr](gpf), EXPRESSIONS[expr](gpt)
    assert tk.to_dict() == jk.to_dict()
    assert str(tk) == str(jk)
    assert tk.canonical_str() == jk.canonical_str()
    assert jax_kernel_from_dict(tk.to_dict()) == jk
    assert gpt.kernel_from_dict(jk.to_dict()).to_dict() == jk.to_dict()


def test_operator_algebra_and_canonical_order():
    se, per, lin = (gpt.SquaredExponentialKernel(), gpt.PeriodicKernel(),
                    gpt.LinearKernel())
    k = se + per + lin
    assert type(k) is gpt.Sum and len(k.terms) == 3
    assert type(se * per * lin) is gpt.Product and len((se * per * lin).terms) == 3
    assert (se + per).canonical_str() == (per + se).canonical_str()
    assert (se * per).canonical_str() == (per * se).canonical_str()
    assert (se + per).canonical_str() != (se * per).canonical_str()
    # the children share their modules, so one set_params reaches every leaf
    k.set_params({"children": ({"lengthscale": torch.tensor(0.2)},
                               {"lengthscale": torch.tensor(0.3),
                                "period": torch.tensor(0.4)},
                               {"offset": torch.tensor([0.5])})})
    assert se.lengthscale is k.terms[0].lengthscale
    assert float(per.period) == pytest.approx(0.4)
    with pytest.raises(KeyError):
        k.set_params({"children": ({"lengthscale": torch.tensor(0.2)},)})


def test_white_noise_on_duplicated_rows():
    """Exact row equality, never a distance test: every duplicated row of a
    d = 3 input counts, in the square and the rectangular blocks."""
    rng = np.random.default_rng(5)
    base = rng.uniform(0, 1, (60, 3)).astype(np.float32)
    x = np.concatenate([base, base[:20]])
    jk = gpf.WhiteNoiseKernel(dim=3, scaled=True)
    jp = {"variance": jnp.asarray(0.7, jnp.float32)}
    tk = gpt.kernel_from_dict(jk.to_dict())
    gpt.params_from_numpy(tk, _np(jp))
    K = tk.gram(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        K, np.asarray(jk.gram(jp, jnp.asarray(x), jnp.asarray(x))))
    assert np.count_nonzero(K) == 80 + 2 * 20
    cross = tk.gram(torch.from_numpy(x[:5]), torch.from_numpy(base[10:])).numpy()
    assert not cross.any()


def test_composite_random_init_within_bounds():
    tk = _mauna(gpt)
    xr, n = [[0.0, 1.0]], 400
    lo, hi = tk.bounds(xr, n)
    p = tk.init_params(xr, n, generator=torch.Generator().manual_seed(4),
                       dtype=torch.float64)
    for v, a, b in zip(tree_leaves(p), tree_leaves(lo), tree_leaves(hi)):
        assert np.all(np.asarray(a) <= v.numpy()) and np.all(v.numpy() <= np.asarray(b))
