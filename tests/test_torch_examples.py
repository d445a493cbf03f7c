"""The port's example scripts (``examples/torch/01``-``10`` without the
multi-process 03, 05 and 09, which have their own tests) at tiny sizes on
the CPU: each ``main(...)`` runs, every number it returns is finite, and
each holds its own invariant. Examples 01 and 08 are also held to their
JAX scripts, run through ``runpy`` at the same ``--n`` in float64 (the
suite enables x64): the numbers those print are parsed and the port's
must lie within 1e-6 relative of them (the tolerance
``tests/test_torch_fit.py`` and ``tests/test_torch_fit_approx.py`` hold
L-BFGS optima and Nyström fits to) plus half a unit in the last printed
digit.
"""
import contextlib
import importlib.util
import io
import math
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu_torch.models.search import (
    default_base_kernels,
)
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NUMBER = r"(-?[0-9.]+)"


def _example(stem):
    path = ROOT / "examples" / "torch" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"example_{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(stem, dtype=torch.float32, **kw):
    """``main(device="cpu", **kw)`` with torch's default dtype set to
    ``dtype`` (float64 where the JAX script runs under the suite's x64)."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        out = _example(stem).main(device="cpu", **kw)
    finally:
        torch.set_default_dtype(old)
    for key, v in out.items():
        if isinstance(v, (int, float)):
            assert math.isfinite(v), (stem, key, v)
    return out


def _jax_script(stem, argv):
    """The JAX script's standard output, run as ``python examples/<stem>.py
    <argv>``."""
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [f"{stem}.py"] + argv
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(ROOT / "examples" / f"{stem}.py"),
                           run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue()


def _printed(text, pattern):
    """The numbers ``pattern`` (with NUMBER groups) finds in ``text``, and
    the number of decimals each was printed with."""
    m = re.search(pattern, text)
    assert m, (pattern, text)
    return [(float(g), len(g.split(".")[1]) if "." in g else 0)
            for g in m.groups()]


def _held(got, printed, what):
    """``got`` within 1e-6 relative of the printed number plus half a unit
    in its last printed digit."""
    ref, decimals = printed
    assert abs(got - ref) <= 1e-6 * abs(ref) + 0.5 * 10.0 ** -decimals, (
        what, got, ref)


def test_01_exact_gp_matches_the_jax_script(tmp_path):
    n = 200
    text = _jax_script("01_exact_gp", ["--n", str(n)])
    svg = tmp_path / "post.svg"
    out = _run("01_exact_gp", n=n, dtype=torch.float64, plot=str(svg))
    assert out["nll_post"] < out["nll_pre"]
    assert svg.stat().st_size > 0
    pre, post = _printed(text, rf"nll {NUMBER} -> {NUMBER}")
    ls, var, noise = _printed(
        text, rf"lengthscale={NUMBER} variance={NUMBER} noise={NUMBER}")
    lo, hi, sd = _printed(
        text, rf"mean range \[{NUMBER}, {NUMBER}\], mean sd {NUMBER}")
    for key, ref in (("nll_pre", pre), ("nll_post", post),
                     ("lengthscale", ls), ("variance", var), ("noise", noise),
                     ("mean_min", lo), ("mean_max", hi), ("mean_sd", sd)):
        _held(out[key], ref, key)


def test_08_approx_fit_matches_the_jax_script():
    """At m = 4 inducing inputs. With m ≥ 8 the script's 300 Adam steps
    over free inducing inputs are chaotic in both packages: a change of
    1e-13 relative in y moves the port's final NLL by up to 5% at m = 16
    to 128, and two runs of the JAX script gave −221.7 and −218.6 at
    n = 300, m = 16. At m = 4 the same change moves it by ~1e-12."""
    n, m = 300, 4
    text = _jax_script("08_approx_fit", ["--n", str(n), "--m", str(m)])
    out = _run("08_approx_fit", n=n, m=m, dtype=torch.float64)
    assert out["nll_post"] < out["nll_pre"] and out["sd_nonnegative"]
    assert (out["lengthscale_lo"] <= out["bounded_lengthscale"]
            <= out["lengthscale_hi"])
    pre, post = _printed(text, rf"nll {NUMBER} -> {NUMBER}")
    (std,) = _printed(text, rf"inducing moved by {NUMBER}")
    lo, hi = _printed(text, rf"posterior mean range \[{NUMBER}, {NUMBER}\]")
    assert "sd>=0: True" in text
    ls, ls_lo, ls_hi = _printed(
        text, rf"bounded fit: lengthscale {NUMBER} in \[{NUMBER}, {NUMBER}\]")
    for key, ref in (("nll_pre", pre), ("nll_post", post),
                     ("inducing_std", std), ("mean_min", lo),
                     ("mean_max", hi), ("bounded_lengthscale", ls),
                     ("lengthscale_lo", ls_lo), ("lengthscale_hi", ls_hi)):
        _held(out[key], ref, key)


def test_02_mauna_loa_composite_fits_and_predicts():
    out = _run("02_mauna_loa_composite", steps=20)
    di = gpt.load_named("mauna_loa", device="cpu")
    assert out["nll_post"] < out["nll_pre"]
    # the posterior mean predicts the held-out rows better than their mean
    assert out["test_mse"] < float(di.y_test.var())


def test_04_svgp_fits_and_predicts():
    out = _run("04_svgp_large", n=2000, m=32, steps=300, batch=256)
    assert out["elbo_last"] < out["elbo_first"]
    # y has variance ~0.64 and noise variance 0.01: the fitted q(f)
    # explains nearly all of the signal
    assert out["pred_mse"] < 0.05


def test_06_pathwise_mean_at_half_is_the_posterior_mean():
    n, t = 300, 101
    out = _run("06_pathwise_sampling", n=n, t=t)
    x, y = gpt.synth_se(n=n, lengthscale=0.2, noise_sd=0.1, seed=0)
    k = gpt.Matern52Kernel(scaled=True).set_params({
        "lengthscale": torch.tensor(0.2), "variance": torch.tensor(1.0)})
    gp = gpt.GaussianProcess(k, noise=0.01, device="cpu").set_data(
        torch.tensor(x, dtype=torch.float32),
        torch.tensor(y, dtype=torch.float32))
    xs = torch.linspace(0, 1, t)[:, None]
    mu = float(gp.posterior(xs[t // 2:t // 2 + 1]).mean[0])
    assert abs(out["mean_at_half"] - mu) <= 3 * out["sd_at_half"], (out, mu)


@pytest.mark.parametrize("stem,kw", [
    ("07_kernel_search", dict(max_depth=1, steps=5)),
    ("10_kernel_search_mauna", dict(max_depth=1, restarts=1, steps=5)),
])
def test_search_examples_score_no_worse_than_the_best_base(stem, kw, capsys):
    out = _run(stem, **kw)
    bases = len(default_base_kernels())
    assert out["candidates"] == len(out["history"]) > bases
    assert all(np.isfinite(s) for _, s in out["history"])
    assert out["bic"] <= min(s for _, s in out["history"][:bases])
    if stem.startswith("10"):
        assert math.isfinite(out["test_mse"])
        assert '"config": "kernel_search_mauna"' in capsys.readouterr().out


@pytest.mark.parametrize("stem", [
    "01_exact_gp", "02_mauna_loa_composite", "04_svgp_large",
    "06_pathwise_sampling", "07_kernel_search", "08_approx_fit",
    "10_kernel_search_mauna"])
def test_examples_default_to_cuda_and_refuse_without_a_card(stem):
    import inspect

    main = _example(stem).main
    assert inspect.signature(main).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main()
