"""The data layer, the auxiliary helpers, the metric factory, the plots and
the profiling helpers of the PyTorch port against the JAX package, on the
CPU in float64.

Splits and random subsets take the JAX package's permutation
(``jr.permutation(PRNGKey(seed), n)``, ``datasets.py:79, :124``) and must
then give the same rows bit for bit, as must the Mauna Loa CSV and the
numpy generators; ``get_metric`` agrees with the JAX package within 1e-9
relative for every family, its random subset-of-data at seed 0 (what the
JAX package always uses).
"""
import json
import logging
import os

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu import compat as jcompat
from gaussianprocessfundamentals_tpu.data import datasets as jdata
from gaussianprocessfundamentals_tpu.utils import auxiliary as jaux
from gaussianprocessfundamentals_tpu_torch import compat as tcompat
from gaussianprocessfundamentals_tpu_torch.data import datasets as tdata
from gaussianprocessfundamentals_tpu_torch.utils import auxiliary as taux
from gaussianprocessfundamentals_tpu_torch.utils import profiling
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)


def _jperm(n, seed=0):
    return np.asarray(jr.permutation(jr.PRNGKey(seed), n))


def _same(t, a):
    np.testing.assert_array_equal(t.numpy(), np.asarray(a))


def _same_input(got, ref):
    for name in ("x_train", "y_train", "x_test", "y_test"):
        _same(getattr(got, name), getattr(ref, name))


def test_split_with_jax_permutation_and_normalisation():
    """``from_arrays`` at test_ratio 0.2 with JAX's seed-3 permutation gives
    JAX's rows; the min-max normalisation round-trips; ranges, inducing
    counts, equidistance; a default (perm=None) split is fixed."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-3, 5, (50, 2))
    y = np.sin(x[:, 0]) + x[:, 1]
    ref = jdata.DataInput.from_arrays(x, y, seed=3)
    got = tdata.DataInput.from_arrays(x, y, perm=_jperm(50, 3), device="cpu")
    _same_input(got, ref)
    _same(got.xrange(), ref.xrange())
    assert got.n_train == ref.n_train == 40 and got.n_inducing() == 20
    nz = got.x_norm
    np.testing.assert_allclose(nz.denormalize(nz.normalize(x)), x, atol=1e-12)
    assert got.x_train.min() >= 0 and got.x_train.max() <= 1
    a = tdata.DataInput.from_arrays(x, y, device="cpu")
    b = tdata.DataInput.from_arrays(
        x, y, perm=torch.Generator().manual_seed(0), device="cpu")
    _same(a.x_test, b.x_test.numpy())
    grid = tdata.DataInput.from_arrays(np.linspace(0, 1, 30), np.zeros(30),
                                       test_ratio=0.0, device="cpu")
    assert grid.is_equidistant() and not got.is_equidistant()
    with pytest.raises(ValueError):
        tdata.DataInput.from_arrays(x, y, perm=np.arange(49), device="cpu")


def test_subsets_match_jax():
    """Random (JAX's permutation), grid and smoothed-grid subsets (the
    default ARD bandwidth and a given Matérn kernel at its defaults, 1e-12),
    the change-point split, and the batched container."""
    x = np.sort(np.random.default_rng(1).uniform(0, 1, (120, 2)), axis=0)
    x[:, 1] *= 50.0
    y = np.sin(6 * x[:, 0]) + np.cos(x[:, 1] / 10)
    jdi = jdata.DataInput(*(jnp.asarray(a) for a in (x, y, x, y)))
    tdi = tdata.DataInput(*(torch.from_numpy(a) for a in (x, y, x, y)))
    _same_input(tdi.subset_random(30, perm=_jperm(120, 2)),
                jdi.subset_random(30, seed=2))
    _same_input(tdi.subset_grid(25), jdi.subset_grid(25))
    for jk, tk in ((None, None),
                   (gpf.Matern52Kernel(), gpt.Matern52Kernel())):
        ref = jdi.subset_smoothed_grid(25, smoothing_kernel=jk)
        got = tdi.subset_smoothed_grid(25, smoothing_kernel=tk)
        _same(got.x_train, ref.x_train)
        np.testing.assert_allclose(got.y_train.numpy(),
                                   np.asarray(ref.y_train), rtol=1e-12,
                                   atol=1e-12)
    for g, r in zip(tdi.split_at_changepoints([0.3, 0.7]),
                    jdi.split_at_changepoints([0.3, 0.7])):
        _same_input(g, r)
    xb = torch.from_numpy(np.stack([x, x + 1]))
    bd = tdata.BatchDataInput(xb, torch.from_numpy(np.stack([y, y])))
    assert bd.batch == 2 and bd.xrange().shape == (2, 2, 2)
    _same(bd.instance(1).x_train, x + 1)
    with pytest.raises(ValueError):
        tdata.BatchDataInput(xb, torch.zeros(2, 5))


def test_rescale_kernel_params_matches_jax():
    x = np.linspace(10.0, 30.0, 40)
    jdi = jdata.DataInput.from_arrays(x, np.sin(x), test_ratio=0.0)
    tdi = tdata.DataInput.from_arrays(x, np.sin(x), test_ratio=0.0,
                                      device="cpu")
    ref = jdi.rescale_kernel_params(gpf.SquaredExponentialKernel(),
                                    {"lengthscale": jnp.asarray(0.1)})
    got = tdi.rescale_kernel_params(
        gpt.SquaredExponentialKernel(),
        {"lengthscale": torch.tensor(0.1, dtype=torch.float64)})
    np.testing.assert_allclose(float(got["lengthscale"]),
                               float(ref["lengthscale"]), rtol=1e-12)


def test_csv_and_generators_match_jax():
    """The Mauna Loa CSV (the one CSV in the repo) through ``load_named``
    and ``load_csv`` with JAX's permutation; the named fallbacks and every
    ``synth_*`` generator bit for bit."""
    ref = jdata.load_named("mauna_loa")
    n = ref.n_train + ref.x_test.shape[0]
    perm = _jperm(n)
    _same_input(tdata.load_named("mauna_loa", perm=perm, device="cpu"), ref)
    path = jdata._find_csv("d2_mauna_loa.csv")
    _same_input(tdata.load_csv(path, x_cols="ALL", perm=perm, device="cpu"),
                jdata.load_csv(path, x_cols="ALL"))
    ref = jdata.load_named("power_plant")
    got = tdata.load_named("power_plant", perm=_jperm(2000), device="cpu")
    _same_input(got, ref)
    assert got.x_train.shape[1] == 4
    for name in ("synth_mauna_loa", "synth_solar_irradiance",
                 "synth_power_plant"):
        for a, b in zip(getattr(tdata, name)(), getattr(jdata, name)()):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tdata.synth_se(n=80, d=2, seed=4),
                    jdata.synth_se(n=80, d=2, seed=4)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdata.synth_seasonal_series(90, 0, 4, 10, 3, 1, 0.5, 7),
                    jdata.synth_seasonal_series(90, 0, 4, 10, 3, 1, 0.5, 7)):
        np.testing.assert_array_equal(a, b)


def test_auxiliary_round_trips():
    """(De)serialisation in ``ravel_pytree``'s order (the JAX vector read
    back), unique rows and the similarity maps against the JAX package."""
    jk = gpf.SquaredExponentialKernel(scaled=True) + gpf.PeriodicKernel()
    jp = jk.init_params([[0.0, 1.0]], 10)
    tk = gpt.SquaredExponentialKernel(scaled=True) + gpt.PeriodicKernel()
    tp = tk.init_params([[0.0, 1.0]], 10, dtype=torch.float64)
    jvec, _ = jaux.serialize_params(jp)
    tvec, unravel = taux.serialize_params(tp)
    np.testing.assert_array_equal(tvec.numpy(), np.asarray(jvec))
    back = taux.deserialize_params(torch.tensor(np.asarray(jvec)) * 2, tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    gpt.utils.tree.tree_leaves(back)):
        np.testing.assert_array_equal(b.numpy(), 2 * np.asarray(a))
    x = np.array([[3.0, 4.0], [1.0, 2.0], [1.0, 2.0], [1.0, -1.0]])
    _same(taux.unique_rows(torch.from_numpy(x)),
          jaux.unique_rows(jnp.asarray(x)))
    d = np.array([0.0, 0.5, 4.0])
    for tt, jt in zip(taux.SimilarityTransform, jaux.SimilarityTransform):
        np.testing.assert_allclose(
            taux.similarity_from_distance(torch.from_numpy(d), tt).numpy(),
            np.asarray(jaux.similarity_from_distance(jnp.asarray(d), jt)),
            rtol=1e-15)


def _metric_problem(n=96):
    """sin(8x) + 0.1ε at n = 96, SE~s (ℓ 0.2, σ_f² 1): the problem of
    ``tests/test_torch_approx.py``. The SKC upper bound stops its inner CG
    after 10 unconverged steps, which amplify round-off in both packages;
    on this problem they agree to 1e-10, on synth_se's at n = 96 to 2e-6."""
    rng = np.random.default_rng(0)
    x = np.sort(rng.uniform(0, 1, (n, 1)), 0)
    y = np.sin(8 * x[:, 0]) + 0.1 * rng.standard_normal(n)
    p = {"lengthscale": 0.2, "variance": 1.0}
    jk = gpf.SquaredExponentialKernel(scaled=True)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tk = gpt.params_from_numpy(gpt.SquaredExponentialKernel(scaled=True),
                               {k: np.float64(v) for k, v in p.items()})
    return x, y, jk, jp, tk


LL = jcompat.MetricType.LL
FAMILIES = [
    ("ll", (LL,), {}),
    ("ll_cg", (LL,), {"handling": "LINEAR_CONJUGATE_GRADIENT"}),
    ("nystroem", (LL, "BASIC_NYSTROEM"), {}),
    ("skc_lower", (LL, "SKC_LOWER_BOUND"), {}),
    ("skc_upper", (LL, "SKC_UPPER_BOUND"), {}),
    ("ski", (LL, "SKI"), {}),
    ("bic", (jcompat.MetricType.BIC,), {}),
    ("mse", (jcompat.MetricType.MSE,), {}),
    ("sod_random", (LL,), {"subset": "RANDOM", "subset_ratio": 0.3}),
    ("sod_grid", (jcompat.MetricType.BIC,),
     {"subset": "GRID", "subset_ratio": 0.3}),
    ("sod_smoothed", (LL,), {"subset": "SMOOTHED_GRID", "subset_ratio": 0.3}),
]


def _enum_args(mod, args, kw):
    out = [getattr(mod.MetricType, args[0].name)]
    if len(args) > 1:
        out.append(getattr(mod.MatrixApproximations, args[1]))
    kw = dict(kw)
    if "handling" in kw:
        kw["handling"] = getattr(mod.NumericalMatrixHandlingType,
                                 kw["handling"])
    if "subset" in kw:
        kw["subset"] = getattr(mod.SubsetOfDataApproaches, kw["subset"])
    return out, kw


@pytest.mark.parametrize("name,args,kw", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_get_metric_matches_jax(name, args, kw):
    x, y, jk, jp, tk = _metric_problem()
    ja, jkw = _enum_args(jcompat, args, kw)
    ta, tkw = _enum_args(tcompat, args, kw)
    jf, tf = jcompat.get_metric(*ja, **jkw), tcompat.get_metric(*ta, **tkw)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), \
        torch.from_numpy(y)
    noise = 0.1
    jf = jax.jit(jf, static_argnums=0)
    if name == "mse":
        ref = jf(jk, jp, jx[::2], jy[::2], jx[1::2], jy[1::2], noise)
        got = tf(tk, tx[::2], ty[::2], tx[1::2], ty[1::2], noise)
    elif name == "ski":
        # CG to 1e-12 in both: at SKI's default 1e-6 the two solves stop
        # at different round-off
        grid = np.linspace(x.min(), x.max(), 40)[:, None]
        ref = jf(jk, jp, jx, jy, jnp.asarray(grid), noise, cg_tol=1e-12)
        got = tf(tk, tx, ty, torch.from_numpy(grid), noise, cg_tol=1e-12)
    elif len(args) > 1:
        ref = jf(jk, jp, jx, jy, jx[::4], noise)
        got = tf(tk, tx, ty, tx[::4], noise)
    else:
        ref = jf(jk, jp, jx, jy, noise)
        got = tf(tk, tx, ty, noise)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-9)


def test_get_metric_blockwise_and_refusal():
    x1, y1 = gpf.synth_se(n=40, seed=0)
    x2, y2 = gpf.synth_se(n=30, seed=1)
    x2 = x2 + 1.0
    jks = [gpf.SquaredExponentialKernel(), gpf.Matern32Kernel()]
    jps = [{"lengthscale": jnp.asarray(0.2)},
           {"lengthscale": jnp.asarray(0.3)}]
    tks = [gpt.params_from_numpy(gpt.SquaredExponentialKernel(),
                                 {"lengthscale": np.float64(0.2)}),
           gpt.params_from_numpy(gpt.Matern32Kernel(),
                                 {"lengthscale": np.float64(0.3)})]
    jx = [jnp.asarray(a) for a in (x1, x2)]
    jy = [jnp.asarray(a) for a in (y1, y2)]
    tx = [torch.from_numpy(a) for a in (x1, x2)]
    ty = [torch.from_numpy(a) for a in (y1, y2)]
    for mt in ("LL", "BIC"):
        jf = jcompat.get_metric(getattr(jcompat.MetricType, mt),
                                blockwise=True)
        ref = jax.jit(lambda ps, xs, ys: jf(jks, ps, xs, ys, 0.1))(jps, jx, jy)
        got = tcompat.get_metric(getattr(tcompat.MetricType, mt),
                                 blockwise=True)(tks, tx, ty, 0.1)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-9)
    ref = jcompat.get_metric(jcompat.MetricType.MSE, blockwise=True)(
        jks, jps, list(zip(jx, jy)), list(zip(jx, jy)), 0.1)
    got = tcompat.get_metric(tcompat.MetricType.MSE, blockwise=True)(
        tks, list(zip(tx, ty)), list(zip(tx, ty)), 0.1)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-9)
    with pytest.raises(ValueError):
        tcompat.get_metric(tcompat.MetricType.LL,
                           tcompat.MatrixApproximations.BASIC_NYSTROEM,
                           blockwise=True)
    assert tcompat.init(tf_parallel=4, jitter=1e-6).jitter == 1e-6
    # another seed draws another random subset
    x, y, _, _, tk = _metric_problem()
    f0, f1 = (tcompat.get_metric(
        tcompat.MetricType.LL, subset=tcompat.SubsetOfDataApproaches.RANDOM,
        subset_ratio=0.3, seed=s) for s in (0, 1))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    assert float(f0(tk, tx, ty, 0.01)) != float(f1(tk, tx, ty, 0.01))


def test_plots_write_files(tmp_path):
    x = torch.linspace(0, 1, 50, dtype=torch.float64)
    mu, sd = torch.sin(6 * x), 0.1 + 0.05 * x
    out = gpt.plot_posterior(x, mu, sd, x_train=x[:30], y_train=mu[:30],
                             y_test=mu, changepoints=[0.5],
                             path=str(tmp_path / "post.svg"))
    assert os.path.getsize(out) > 1000
    draws = torch.randn(3, 50, generator=torch.Generator().manual_seed(0),
                        dtype=torch.float64)
    out = gpt.plot_prior_samples(x[:, None], draws,
                                 path=str(tmp_path / "prior.svg"))
    assert os.path.getsize(out) > 1000


def test_profiling_helpers(tmp_path, caplog):
    """``timed`` and ``StepLogger`` log; ``trace`` writes a Chrome trace
    that holds a labelled range; ``enable_debug_checks`` turns anomaly mode
    on (and off again)."""
    records = []
    step_log = profiling.StepLogger(every=2, sink=records.append)
    for step in range(5):
        step_log(step, 1.0 / (step + 1), grad_norm=0.5)
    assert [json.loads(r)["step"] for r in records] == [0, 2, 4]
    assert set(json.loads(records[0])) == {"step", "loss", "dt", "grad_norm"}
    with caplog.at_level(logging.INFO, logger="gpf_torch"):
        with profiling.timed("tiny matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert "tiny matmul took" in caplog.text
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.named_scope("gp_block"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    assert prof is not None
    text = (tmp_path / "trace.json").read_text()
    assert "gp_block" in text
    with profiling.trace(None) as prof:
        pass
    assert prof is None
    try:
        profiling.enable_debug_checks()
        assert torch.is_anomaly_enabled()
    finally:
        profiling.enable_debug_checks(False)
    assert not torch.is_anomaly_enabled()
