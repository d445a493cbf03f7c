"""The greedy kernel search of the PyTorch port against the JAX package
(float64, CPU), the candidates' independence (the port's kernels are
modules that hold their fitted parameters), and the port of
``tests/test_search.py``.
"""
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.models.search import (
    greedy_kernel_search as jax_search,
)
from gaussianprocessfundamentals_tpu_torch.models import search as search_mod
from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)


def _data(n, seed=0):
    """A periodic signal on a linear trend: a composite models it best."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1, (n, 1)), axis=0)
    y = (np.sin(2 * np.pi * x[:, 0] / 0.25) + 2.0 * x[:, 0]
         + 0.05 * rng.standard_normal(n))
    return x, y


def test_greedy_search_matches_jax():
    """n = 60, bases SE~s and LIN, one expansion round, 40 Adam steps per
    candidate: the same candidates in the same order, each BIC within rtol
    1e-8 (the port's Adam is optax's update rule; the two agree to ~1e-11
    here), the same winner, its parameters within rtol 1e-6."""
    x, y = _data(60)
    ref = jax_search(jnp.asarray(x), jnp.asarray(y),
                     base_kernels=(gpf.SquaredExponentialKernel(scaled=True),
                                   gpf.LinearKernel()),
                     max_depth=1, key=jr.PRNGKey(0), fit_kwargs={"steps": 40})
    got = gpt.greedy_kernel_search(
        torch.from_numpy(x), torch.from_numpy(y),
        base_kernels=(gpt.SquaredExponentialKernel(scaled=True),
                      gpt.LinearKernel()),
        max_depth=1, fit_kwargs={"steps": 40})
    assert [n for n, _ in got.history] == [n for n, _ in ref.history]
    np.testing.assert_allclose([s for _, s in got.history],
                               [s for _, s in ref.history], rtol=1e-8)
    assert str(got.kernel) == str(ref.kernel)
    np.testing.assert_allclose(got.score, ref.score, rtol=1e-8)
    for a, b in zip(tree_leaves(got.kernel.get_params()),
                    tree_leaves(ref.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_candidates_share_no_installed_parameters(monkeypatch):
    """Every candidate keeps the parameters its own fit installed to the
    end of a two-round search (``current + b`` and ``current * b`` would
    share modules with the best kernel and the bases without deep copies),
    the caller's base kernels get none, and the result's kernel carries
    the parameters the result reports."""
    fitted = []

    def recording_fit(kernel, *args, **kwargs):
        res = real_fit(kernel, *args, **kwargs)
        fitted.append((kernel, [t.clone() for t in
                                tree_leaves(kernel.get_params())]))
        return res

    real_fit = search_mod.fit
    monkeypatch.setattr(search_mod, "fit", recording_fit)
    x, y = _data(50, seed=1)
    bases = (gpt.SquaredExponentialKernel(scaled=True), gpt.LinearKernel())
    res = gpt.greedy_kernel_search(torch.from_numpy(x), torch.from_numpy(y),
                                   base_kernels=bases, max_depth=2,
                                   fit_kwargs={"steps": 15})
    assert len(fitted) == len(res.history) > len(bases)
    for kernel, params in fitted:
        now = tree_leaves(kernel.get_params())
        assert all(torch.equal(a, b) for a, b in zip(now, params)), \
            str(kernel)
    assert not any(b.has_params() for b in bases)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(res.kernel.get_params()), tree_leaves(res.params)))


def test_search_improves_over_single_base():
    """Port of ``tests/test_search.py::test_search_improves_over_single_base``."""
    x, y = _data(150)
    res = gpt.greedy_kernel_search(torch.from_numpy(x), torch.from_numpy(y),
                                   max_depth=1, fit_kwargs={"steps": 120})
    n_base = len(search_mod.default_base_kernels())
    assert np.isfinite(res.score)
    base_scores = [s for _, s in res.history[:n_base]]
    assert res.score <= min(base_scores) + 1e-6
    assert len(res.history) >= n_base * 3
    comp_scores = [s for name, s in res.history if "+" in name or "*" in name]
    assert min(comp_scores) < min(base_scores) + 5.0
