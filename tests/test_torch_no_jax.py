"""The PyTorch package stands alone: importing it, fitting and serving a
posterior load no JAX, and importing it needs no CUDA, nvcc or triton."""
import json
import os
import subprocess
import sys
from pathlib import Path

from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import importlib, json, pkgutil, sys
import numpy as np
import torch
import gaussianprocessfundamentals_tpu_torch as gpt

# import every module of the package, the CUDA build and kernel wrappers too
for mod in pkgutil.walk_packages(gpt.__path__, gpt.__name__ + "."):
    importlib.import_module(mod.name)

rng = np.random.default_rng(0)
x = np.sort(rng.uniform(0, 1, (300, 1)), 0).astype(np.float32)
y = np.sin(8 * x[:, 0]) + 0.1 * rng.standard_normal(300).astype(np.float32)
k = gpt.SquaredExponentialKernel()
gpt.params_from_numpy(k, {"lengthscale": np.float32(0.1)})
gp = gpt.GaussianProcess(k, noise=1e-2, device="cpu").set_data(x, y)
post = gp.posterior(np.linspace(0, 1, 20, dtype=np.float32)[:, None],
                    method="iterative")
fitted = gpt.GaussianProcess(gpt.SquaredExponentialKernel(scaled=True),
                             gpt.ConstantMean() + gpt.LinearMean(dim=1),
                             device="cpu")
res = fitted.fit(x, y, method="iterative", steps=3, precond_m=16, max_iters=20,
                 materialize=False)
mauna = (gpt.SquaredExponentialKernel(scaled=True) * gpt.PeriodicKernel()
         + gpt.SquaredExponentialKernel(scaled=True) + gpt.LinearKernel()
         + gpt.WhiteNoiseKernel(scaled=True))
composite = gpt.GaussianProcess(mauna, device="cpu")
res2 = composite.fit(x, y, method="iterative", steps=3, precond_m=16,
                     max_iters=20, materialize=False)
post2 = composite.posterior(np.linspace(0, 1, 20, dtype=np.float32)[:, None],
                            method="iterative")
# the dense route's slice: a change-point segmented GP, sampling, k-fold
bw = gpt.BlockwiseGP([gpt.SquaredExponentialKernel(scaled=True),
                      gpt.Matern52Kernel(scaled=True)], locations=[0.5],
                     device="cpu")
bw.fit(x, y, optimize_noise=True)
mu, _, _, var = bw.predict(np.linspace(0, 1, 30, dtype=np.float32)[:, None])
draws = bw.gps[0].sample_posterior(np.linspace(0, 0.4, 10, dtype=np.float32)[:, None],
                                   torch.Generator().manual_seed(0), 4)
cp = gpt.ChangePoint(children=(gpt.SquaredExponentialKernel(),
                               gpt.PeriodicKernel()))
kf = gpt.fit(cp, torch.from_numpy(x[:80]), torch.from_numpy(y[:80]), kfold=3,
             optimize_noise=True, generator=torch.Generator().manual_seed(0))
# the approximation slice: a Nystroem fit with trainable inducing inputs and
# its projected-process posterior, SKI, SciPy's BFGS, independent batched
# fits and the float64 Toeplitz oracle
ny = gpt.GaussianProcess(gpt.SquaredExponentialKernel(scaled=True), device="cpu")
ny.fit(x, y, method="adam", steps=3, optimize_noise=True,
       approximation="nystroem", n_inducing=16, optimize_inducing=True)
post3 = ny.posterior(np.linspace(0, 1, 20, dtype=np.float32)[:, None])
xs, ys = torch.from_numpy(x[:120]), torch.from_numpy(y[:120])
ski = gpt.fit(gpt.SquaredExponentialKernel(), xs, ys, method="adam", steps=2,
              optimize_noise=True, approximation="ski")
bfgs = gpt.fit(gpt.SquaredExponentialKernel(), xs, ys, method="scipy-bfgs",
               optimize_noise=True)
_, noises, finals = gpt.fit_batch_independent(
    gpt.SquaredExponentialKernel(), torch.stack([xs[:60], xs[60:]]),
    torch.stack([ys[:60], ys[60:]]), steps=3)
from gaussianprocessfundamentals_tpu_torch.utils.toeplitz_oracle import (
    se_grid_posterior_oracle)
_, var_o, rel_o = se_grid_posterior_oracle(
    500, 0.05, 1e-2, np.array([0.3, 0.6]), np.sin(np.linspace(0, 3, 500)))
# SVGP, pathwise draws through random Fourier features, the kernel search
# and a batched (instance-stacked) fit
xt_, yt_ = torch.from_numpy(x), torch.from_numpy(y)
sk = gpt.SquaredExponentialKernel(scaled=True)
sp, shist = gpt.fit_svgp(sk, xt_, yt_, m=16, steps=3, batch_size=64,
                         generator=torch.Generator().manual_seed(0))
smu, svar = gpt.svgp_predict(sk, sp, xt_[:20])
pk = gpt.params_from_numpy(gpt.Matern52Kernel(scaled=True), {
    "lengthscale": np.float32(0.2), "variance": np.float32(1.0)})
paths = gpt.pathwise_posterior_samples(
    pk, xt_, yt_, xt_[:20], 1e-2, torch.Generator().manual_seed(0),
    num_samples=4, num_features=64, max_iters=20)
found = gpt.greedy_kernel_search(
    xt_[:60], yt_[:60], base_kernels=(gpt.SquaredExponentialKernel(scaled=True),),
    max_depth=0, fit_kwargs={"steps": 3})
bfit = gpt.fit(gpt.SquaredExponentialKernel(), torch.stack([xt_[:40], xt_[40:80]]),
               torch.stack([yt_[:40], yt_[40:80]]), method="adam", steps=3)
# MCMC: a 5-draw NUTS chain and two lock-step GP chains, the data layer,
# the metric factory and the profiling helpers
nres = gpt.nuts(lambda q: -0.5 * torch.sum(q["x"] ** 2),
                {"x": torch.zeros(2, dtype=torch.float64)},
                torch.Generator().manual_seed(0), num_samples=5,
                num_warmup=4, max_depth=3)
xg, yg = gpt.synth_se(n=40, lengthscale=0.2, noise_sd=0.1, seed=0)
snll = gpt.make_stacked_nll(gpt.Matern52Kernel(scaled=True), gpt.ZeroMean(),
                            torch.from_numpy(xg), torch.from_numpy(yg),
                            optimize_noise=True)
u0 = {"kernel": {"lengthscale": torch.full((2,), -1.5, dtype=torch.float64),
                 "variance": torch.zeros(2, dtype=torch.float64)},
      "mean": {}, "log_noise": torch.full((2,), -4.0, dtype=torch.float64)}
cres = gpt.nuts_chains(lambda u: -snll(u), u0, torch.Generator().manual_seed(1),
                       num_samples=3, num_warmup=2, max_depth=3)
di = gpt.load_named("mauna_loa", device="cpu")
sub = di.subset_smoothed_grid(50)
ll = gpt.compat.get_metric(gpt.compat.MetricType.LL)(
    gpt.params_from_numpy(gpt.SquaredExponentialKernel(),
                          {"lengthscale": np.float64(0.1)}),
    sub.x_train, sub.y_train, 0.01)
with gpt.timed("tiny"):
    vec, _ = gpt.serialize_params(u0)
# every example script of the port (their argument parsing sits under
# __main__, so importing one runs nothing)
import importlib.util, pathlib
examples = sorted(pathlib.Path("examples/torch").glob("*.py"))
for path in examples:
    spec = importlib.util.spec_from_file_location("example_" + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "reference": sorted(m for m in sys.modules
                        if m.startswith("gaussianprocessfundamentals_tpu.")
                        or m == "gaussianprocessfundamentals_tpu"),
    "triton": "triton" in sys.modules,
    "finite": bool(torch.isfinite(post.mean).all() and torch.isfinite(post.var).all()
                   and torch.isfinite(res.history).all()
                   and torch.isfinite(res2.history).all()
                   and torch.isfinite(post2.mean).all()
                   and torch.isfinite(mu).all() and torch.isfinite(var).all()
                   and torch.isfinite(draws).all()
                   and bool(np.isfinite(bw.log_marginal_likelihood()))
                   and bool(np.isfinite(kf.nll_post))
                   and torch.isfinite(post3.mean).all() and torch.isfinite(post3.var).all()
                   and bool(np.isfinite(ski.nll_post)) and bool(np.isfinite(bfgs.nll_post))
                   and torch.isfinite(noises).all() and torch.isfinite(finals).all()
                   and bool(np.isfinite(var_o).all()) and rel_o < 1e-10
                   and torch.isfinite(shist).all() and torch.isfinite(smu).all()
                   and torch.isfinite(svar).all() and torch.isfinite(paths).all()
                   and bool(np.isfinite(found.score))
                   and bool(np.isfinite(bfit.nll_post))
                   and torch.isfinite(nres.log_probs).all()
                   and torch.isfinite(cres.log_probs).all()
                   and bool(torch.isfinite(ll)) and vec.shape == (6,)),
    "nuts_draws": list(nres.samples["x"].shape) + list(cres.log_probs.shape),
    "fit_steps": len(res.history) + len(res2.history),
    "examples": [p.stem[:2] for p in examples],
}))
"""


def test_port_imports_and_serves_without_jax():
    """Also 3-step iterative fits on the streamed route, of an SE kernel
    (K1 + K2 plain) and of the Mauna Loa composite (K3 + K4 plain), and the
    composite's posterior; a BlockwiseGP fit, prediction and log marginal
    likelihood on the dense route (K5 + K6 plain), posterior draws, a
    k-fold fit of a ChangePoint kernel, and the approximation slice: a
    Nyström fit and its projected-process posterior, an SKI fit, a SciPy
    BFGS fit, independent batched fits and the Toeplitz oracle; a 3-step
    SVGP fit and its predictive, pathwise draws through random Fourier
    features, a one-base kernel search and a batched fit; a 5-draw NUTS
    chain, two lock-step NUTS chains on the stacked GP NLL, the Mauna Loa
    CSV, a smoothed-grid subset, the metric factory and a timer; and it
    imports every script in ``examples/torch`` (01-10)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"  # one torch thread, as in the other port tests
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"jax": [], "reference": [], "triton": False, "finite": True,
                   "fit_steps": 6, "nuts_draws": [5, 2, 2, 3],
                   "examples": [f"{i:02d}" for i in range(1, 11)]}


def test_no_module_of_the_port_imports_jax():
    """Also the imports inside functions, which the run above may not
    reach, in the package and in its example scripts."""
    paths = sorted((ROOT / "gaussianprocessfundamentals_tpu_torch").rglob("*.py"))
    examples = sorted((ROOT / "examples" / "torch").glob("*.py"))
    assert paths and len(examples) == 10
    paths += examples
    for path in paths:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                name = stripped.split()[1]
                assert "jax" not in name, (path, line)
                assert name.split(".")[0] != "gaussianprocessfundamentals_tpu", (
                    path, line)
