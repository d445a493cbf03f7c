"""Time, on one GPU, the routes on either side of the four limits the port
inherited from the JAX package's TPU runs, and print them as a table:

* ``fit/fit.py`` ``_AUTO_ITERATIVE_N`` (8,000 rows): one NLL + gradient
  evaluation of the dense Cholesky route (``make_nll`` under autograd, what
  L-BFGS calls) against one of the iterative route
  (``iterative_nll_and_grad`` with ``fit_iterative``'s defaults: 8 probes,
  a rank-128 preconditioner, at most 100 CG iterations to 1e-6);
* ``models/exact.py`` ``_AUTO_ITERATIVE_POST_N`` (20,000 rows): the dense
  posterior against the chunked mBCG one, 1,000 test points;
* ``models/iterative.py`` ``_MATERIALIZE_MAX_N`` (40,000 rows): the
  iterative NLL + gradient with K materialised against streamed;
* ``config.dense_hbm_budget`` (40 GB): each dense step's peak device
  memory beside the 3·n²·4 bytes ``fit`` budgets for it.

    python3 tools/crossover_sweep.py

SE kernel, ℓ = 0.1, variance 1, σ² = 1e-2, on chip_smoke.py's data (sorted
x ~ U(0, 1), y = sin(8x) + 0.1ε), float32 with TF32 off. Each time is the
median of three host-clock runs ending in ``torch.cuda.synchronize()``,
after one warm-up run. Prints one line per measurement and a JSON
object last; writes it to ``chiprun_out/crossover_sweep.json`` too.
Without a GPU it fails.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
FIT_N = (4_000, 6_000, 8_000, 12_000, 16_000)
POST_N = (8_000, 12_000, 16_000, 20_000, 24_000, 32_000)
MAT_N = (10_000, 20_000, 30_000, 40_000, 50_000)
T_TEST = 1_000
NOISE = 1e-2


def _timed(fn, reps: int = 3):
    """(median seconds, peak bytes) of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), torch.cuda.max_memory_allocated()


def _problem(n: int):
    import gaussianprocessfundamentals_tpu_torch as gpt

    g = torch.Generator().manual_seed(n)
    x = torch.sort(torch.rand(n, 1, generator=g), dim=0).values.cuda()
    y = (torch.sin(8.0 * x[:, 0]).cpu()
         + 0.1 * torch.randn(n, generator=g)).cuda()
    kernel = gpt.SquaredExponentialKernel(scaled=True).set_params({
        "lengthscale": torch.tensor(0.1), "variance": torch.tensor(1.0)}).cuda()
    return kernel, x, y


def _dense_step(kernel, x, y):
    """One dense NLL + gradient, as L-BFGS evaluates it."""
    from gaussianprocessfundamentals_tpu_torch.fit.fit import make_nll
    from gaussianprocessfundamentals_tpu_torch.fit.transforms import (
        leaf_copy,
        unconstrain,
    )
    from gaussianprocessfundamentals_tpu_torch.means.functions import ZeroMean

    before = kernel.get_params()
    u = leaf_copy({"kernel": unconstrain(kernel.positivity(), before),
                   "mean": {},
                   "log_noise": torch.log(torch.tensor(NOISE, device="cuda"))})
    nll = make_nll(kernel, ZeroMean(), x, y, optimize_noise=True)

    def step():
        loss = nll(u)
        loss.backward()
        return loss

    try:
        return _timed(step)
    finally:
        kernel.set_params(before)


def _iterative_step(kernel, x, y, materialize=None):
    from gaussianprocessfundamentals_tpu_torch.models.iterative import (
        iterative_nll_and_grad,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    noise = torch.tensor(NOISE, device="cuda")
    return _timed(lambda: iterative_nll_and_grad(
        kernel, x, y, noise, gen, materialize=materialize))


def _posterior(kernel, x, y, method):
    import gaussianprocessfundamentals_tpu_torch as gpt

    gp = gpt.GaussianProcess(kernel, noise=NOISE, device="cuda").set_data(x, y)
    xt = torch.linspace(0.0, 1.0, T_TEST, device="cuda")[:, None]
    return _timed(lambda: gp.posterior(xt, method=method))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("crossover_sweep: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from gaussianprocessfundamentals_tpu_torch.config import DEFAULT_CONFIG

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[sweep] {card}; budget {DEFAULT_CONFIG.dense_hbm_budget / 1e9:g} "
          "GB", flush=True)
    rows = {"card": card, "fit": [], "posterior": [], "materialize": []}
    for n in FIT_N:
        kernel, x, y = _problem(n)
        (d_s, d_peak), (i_s, i_peak) = (_dense_step(kernel, x, y),
                                        _iterative_step(kernel, x, y))
        rows["fit"].append({"n": n, "dense_s": d_s, "iterative_s": i_s,
                            "dense_peak_gb": d_peak / 1e9,
                            "budgeted_gb": 3 * n * n * 4 / 1e9,
                            "iterative_peak_gb": i_peak / 1e9})
        print(f"[sweep] fit step n={n}: dense {1e3 * d_s:.1f} ms (peak "
              f"{d_peak / 1e9:.3f} GB, budgeted 3n²·4 = "
              f"{3 * n * n * 4 / 1e9:.3f} GB), iterative {1e3 * i_s:.1f} ms "
              f"(peak {i_peak / 1e9:.3f} GB)", flush=True)
    for n in POST_N:
        kernel, x, y = _problem(n)
        (d_s, d_peak), (i_s, i_peak) = (_posterior(kernel, x, y, "dense"),
                                        _posterior(kernel, x, y, "iterative"))
        rows["posterior"].append({"n": n, "dense_s": d_s, "iterative_s": i_s,
                                  "dense_peak_gb": d_peak / 1e9,
                                  "iterative_peak_gb": i_peak / 1e9})
        print(f"[sweep] posterior n={n} t={T_TEST}: dense {1e3 * d_s:.1f} ms "
              f"(peak {d_peak / 1e9:.3f} GB), chunked {1e3 * i_s:.1f} ms "
              f"(peak {i_peak / 1e9:.3f} GB)", flush=True)
    for n in MAT_N:
        kernel, x, y = _problem(n)
        (m_s, m_peak), (s_s, s_peak) = (
            _iterative_step(kernel, x, y, materialize=True),
            _iterative_step(kernel, x, y, materialize=False))
        rows["materialize"].append({"n": n, "materialized_s": m_s,
                                    "streamed_s": s_s,
                                    "materialized_peak_gb": m_peak / 1e9,
                                    "streamed_peak_gb": s_peak / 1e9})
        print(f"[sweep] iterative step n={n}: materialised {1e3 * m_s:.1f} ms "
              f"(peak {m_peak / 1e9:.3f} GB), streamed {1e3 * s_s:.1f} ms "
              f"(peak {s_peak / 1e9:.3f} GB)", flush=True)
    out = ROOT / "chiprun_out" / "crossover_sweep.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    print(json.dumps(rows), flush=True)


if __name__ == "__main__":
    main()
