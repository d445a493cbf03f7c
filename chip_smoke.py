"""Drive the PyTorch port's serving and training paths once on one GPU:
for an SE kernel (K1 and K2), for the Mauna Loa composite (K3 and K4), on
the dense exact route with its Gram kernels (K5 and K6): dense serving,
sampling, and segmented GPs at N = 100k; then the JAX package's 50k
variance gate, a fit and posterior at N = 200k, where a float32 K cannot
exist on the card, and the approximations (Nyström with its
projected-process posterior through K5/K6, the SKC bounds, SKI); then SVGP
at N = 100k and pathwise posterior draws at N = 20k through K5/K6, the
greedy kernel search on the Mauna Loa record, and a batched fit; then
BASELINE config 3, NUTS over a Matérn-5/2 GP's hyperparameters with 8
chains on a batch axis, and the metric factory and data layer on the card;
then the multi-GPU slice over ranks on the one card: the mesh-sharded
streaming fit and posterior at N = 200k, the block-cyclic distributed
Cholesky at n = 32,768, and HMC and NUTS with one chain per rank.

    python3 chip_smoke.py

Phases (each prints one or more lines; any failure raises and exits
non-zero):

1. device: the card's name and power limit (nvidia-smi), torch/CUDA
   versions and the TF32 flags (both off: full-float32 matmuls);
2. build: every kernel from the checkout, one nvcc for each library, all
   started together: Gram·V (K1, csrc/gram_matvec.cu), the low-rank-
   cotangent gradient (K2, csrc/lowrank_vjp.cu), the dense Gram kernels
   (K5 and K6, csrc/dense_gram.cu), and the composite-expression Gram·V
   (K3, csrc/expr_matvec.cu) and gradient (K4, csrc/expr_vjp.cu) compiled
   with the code generated for each expression of phases 11-17, sm_90a
   (K1 and K3 share the tile loop of csrc/gram_mma.cuh, K2 and K4 that of
   csrc/lowrank_mma.cuh); then ptxas's registers, stack and spills of
   every K1-K6 instantiation, and a failure if any spills;
3. K1 check: K1 against its plain PyTorch version on the card at ragged
   shapes (n1 = 3000 and n2 = 5001: neither a multiple of 16 nor of the
   x2 tile; r = 1, 8, 9, 16, 64, 255, 256, 257), for SE, Matérn-3/2 and
   Matérn-5/2 at d = 1 and SE at d = 3. Phase 5 repeats the check at the
   main path's shapes (n = 100k, r = 1 and 256) and holds K1 at n2 = 100k,
   r = 256 on 2,048 rows of x1 spread over its range to the float64 plain
   version (K3_RTOL·max|ref|: each output sums over all 100k rows);
4. small-n posterior oracle: the iterative posterior (through K1) against a
   float64 dense Cholesky posterior, n = 4096, 64 test points;
5. serving main path: ``GaussianProcess(...).posterior`` at N = 100,000
   training points and 1,000 test points through ``method="auto"`` (the
   matrix-free chunked mBCG route), with K1's launch count, CG residuals,
   accuracy against the noise-free function, peak device memory, and K1's
   time against the plain version's at the main path's shapes;
6. K2 check: K2 against its plain version on the card at ragged shapes,
   the cases of phase 3 and SE at d = 20 and 40 (K2's run-time width) at
   r = 1, 17, 145 and 273 (relative error per scalar ≤ 1e-3), and at
   n = 65,536 against the plain version run in
   float64 (≤ 3e-3): the JAX package's gates ``fused_lrvjp_*``, whose
   cotangent has mean 0.25·r. Each case again at r = 273 with a zero-mean
   cotangent, whose sums cancel as the fit's do, against the float64
   plain version (≤ 1e-4);
7. small-n fit oracle: one iterative NLL + gradient at n = 4096 on the
   streamed route (K1 and K2), 64 probes, against the float64 dense NLL and
   its gradient;
8. training main path: ``GaussianProcess(...).fit(method="auto")`` at
   N = 100,000 with a constant + linear mean, 10 Adam steps of the JAX
   package's 100k fit story (60 there), then a posterior at 1,000 points;
   K1 and K2 launch counts, NLL history, skipped steps, peak memory;
9. the training path's kernels checked and timed against their plain
   versions at its shapes: K2 at n = 100k, r = 2·8 + 256 + 1 = 273 (both
   cotangents of phase 6), and K1 at the CG width r = 9 (y and 8 probes),
   each beside its bound;
10. profile: the fit of phase 8 again, warm (wall and seconds per step),
    then one fit step under ``torch.profiler``: device time by kernel and
    the device's busy share of the step's wall time;
11. K3 check: K3 against its plain version at ragged shapes (n1 = 3000,
    n2 = 5001, r = 1, 8, 9, 16, 255, 256) for each leaf alone -- SE scalar and ARD at
    d = 3, PER, LIN with an ARD offset at d = 3, Matérn-3/2 and -5/2 at
    d = 1 and ARD at d = 3, RQ, CONST -- and the Mauna Loa composite,
    within 5e-5·max|ref| (the JAX gates ``expr_matvec_*``); the composite
    once at n = 65,536 against the float64 plain version; PER where its
    float32 phase is not accurate enough -- at its defaults, at ℓ's lower
    bound 5·range/n and at the period's 10·range/n (n = 100k) -- against
    the float64 plain version, within the same limit;
12. K4 check: the same expressions at r = 1, 17 and 273 with the JAX
    gate's zero-mean cotangent, per parameter array max|diff| / max|ref|
    ≤ 3e-3 (``expr_vjp_mauna``), and at r = 273 against the float64 plain
    version; the sharp PER cases of phase 11 at r = 1, 17 and 273 against
    the float64 plain version;
13. small-n composite oracle: one streamed iterative NLL + gradient of the
    composite at n = 4096 (K3 and K4), 64 probes, against the float64
    dense NLL (2%) and its gradient (15% in relative L2 norm);
14. composite training main path: ``GaussianProcess(SE~s·PER + SE~s + LIN
    + WN~s).fit(method="auto")`` on the JAX package's Mauna-Loa-shaped
    series at N = 100,000 (x and y min-max normalised), the knobs of
    phase 8: NLL history, skipped steps, fitted parameters, peak memory
    (≤ 8 GB), 25 K3 launches and 1 K4 launch per step;
15. composite serving main path: ``.posterior`` of that fit at 1,000
    points midway between training points: CG iterations and true
    residual (≤ 1e-3) per solve, K3 launches, variances ≥ 0, mean RMSE
    against the noise-free series (≤ 0.05 normalised);
16. K3 at r = 1, 9 and 256 (the y-solve, the fit's CG, a posterior chunk)
    and K4 at r = 273 at n = 100k on the composite's training inputs:
    checked against their plain versions (K4 also against float64), then
    timed in turns with them, each beside its bound; K3 at n2 = 100k,
    r = 256 on 2,048 spread rows of x1 against the float64 plain version
    (the chain-length check of phase 5);
17. profile: one composite fit step under ``torch.profiler``;
18. K5/K6 check: ``se_gram`` and ``matern_gram`` against their plain
    versions at n1 = 3000, n2 = 5001 (SE at d = 1, 3, 8, 12 and 40 -- the
    last two the run-time width --, ARD SE at d = 3 through the router,
    the Euclidean Matérn-3/2 and -5/2 at d = 1 and 2; diag_add 0 and 0.25;
    square and cross), and the JAX gates ``se_gram_d1``, ``se_gram_d3``,
    ``matern32_gram_d1`` and ``matern52_gram_d1`` (n = 4096, ℓ = 0.1,
    diag_add 0.25) against the plain version in float32 and in float64,
    each max|diff| / max|ref| < 2e-5;
19. dense serving, the slice's main path: ``GaussianProcess.posterior``
    (``method="auto"``, the dense Cholesky route) at N = 16,384 and 1,000
    test points, for SE~s and then Matérn-5/2~s: exactly 2 K5 or K6
    launches (K + noise, K_s), μ and var against a float64 dense Cholesky
    on the card (1e-3), the median of 5 warm calls split into the Gram
    builds, the Cholesky and the triangular solves, peak memory; then 64
    ``sample_posterior`` draws at those points;
20. segmented GPs at N = 100,000: ``BlockwiseGP`` over 16 change-point
    segments (SE~s and Matérn-5/2~s alternating, ~6,250 rows each, dense
    L-BFGS per segment), fit, predict at 10,000 points and log marginal
    likelihood: no K5/K6 launch in the fit, 24 of each in predict and the
    likelihood, RMSE against the noise-free function < 0.05;
21. ``PartitionedGP`` over 4 boxes of d = 2 inputs, N = 20,000 (K5 at
    d = 2), fit and predict; ``fit_segments_vmapped`` of SE~s over the 16
    segments of phase 20, 20 Adam steps as one batched program;
22. K5 and K6 at the JAX package's benchmark sizes (n = 10,000 and
    50,000), at the dense paths' shapes (16,384², 6,250² and the
    [100,000 × 256] K_s of a posterior chunk, the boxes of phase 21 at
    d = 2, the Nyström posterior's 100,000 × 2,048, 2,048² and
    1,000 × 2,048 of phase 26), at ragged segment sizes (m mod 4 = 1, 2
    and 3: 6,105², 6,511², 6,511 × 651) and at d = 12 and 20 (K5) and
    d = 2 for both ν (K6), and phases 28 and 29's 512² (with SVGP's
    jitter floor), 512 × 100,000, 20,000² (σ² + jitter) and
    20,000 × 1,000:
    each checked against its plain version, then its device time (a CUDA
    graph of back-to-back launches, each into memory of its own, replayed
    between CUDA events) and share of the bound, and the per-call wall of
    kernel and plain version in turns (CUDA events over back-to-back
    calls, the wrappers' host work included), beside
    ``torch.linalg.cholesky`` of the same square matrix;
23. a covariance K1-K4 do not cover, ChangePoint(SE~s, SE~s) with a
    sigmoid gate: ``GaussianProcess.posterior`` at N = 20,480 (the chunked
    mBCG route, 200 test points) against the float64 dense posterior on
    the card (μ within 1e-3·max|μ|, var within 5e-2·max|var| as in phase
    19, true residual ≤ 1e-3,
    RMSE < 0.01), a streamed NLL + gradient at n = 4096 against the
    float64 dense ones (phase 7's gates), and one at n = 45,000, above the
    materialisation cap: the routers take the plain streamed versions, and
    no K1-K4 launch is counted;
24. the JAX gate ``posterior_var_50k_vs_f64_oracle``: the float32
    ``iterative_posterior`` at n = 50,000 on the grid i/(n−1) (SE ℓ = 0.05,
    σ² = 1e-2, 32 test points) against the float64 Toeplitz/FFT oracle
    (``utils/toeplitz_oracle.py``): max|var − oracle| < 1e-3, the oracle's
    relative residual < 1e-10, μ's error printed (and, not gated, the
    same problem on the chunked route, which reports each solve's CG
    iterations and true residual);
25. the 200k story: ``GaussianProcess(SE~s, Constant + Linear).fit(
    method="auto")`` at N = 200,000 (a float32 K would be 160 GB), 30 Adam
    steps with phase 8's knobs, then ``.posterior`` at 1,000 points on the
    chunked route: NLL history, skipped steps (none allowed), recovered
    noise and mean, CG residuals (≤ 1e-3), RMSE against the noise-free
    function (< 0.01), peak memory (< 8 GB), K1/K2/K5 launches;
26. example 08 at N = 100,000: a Nyström fit of SE~s (20 Adam steps,
    m = 2,048 inducing inputs optimised), then the facade's
    projected-process posterior at 1,000 points, exactly one K5 launch per
    Gram (K_nm, K_mm, K_tm), μ within 1e-3·max|μ| and var within
    5e-2·max|var| of ``nystroem_posterior`` in float64 at the same
    parameters, inducing set and jitter level (the one the float32 K_mm
    needed; the distance to the float64 posterior at the configuration's
    jitter, another regularisation, is printed beside it); each Gram
    shape held against the plain version; the same for Matérn-5/2~s (K6),
    and for SE~s at the default ratio m = 10,000 after 3 steps;
27. the SKC bounds and the Nyström log likelihood at n = 4,096 (float32,
    value and gradient): skc_lower ≤ float64 dense log likelihood ≤
    skc_upper; SKI's two log likelihoods at N = 20,000 on 2,000 grid
    points, value and gradient finite, with their CG iteration counts;
28. BASELINE config 4 (example 04): ``fit_svgp`` of SE~s at N = 100,000,
    m = 512, batch 4,096, lr 1e-2, 3,000 Adam steps in float32 (steps/s,
    −ELBO first and last, no NaN in the history, peak memory), then
    ``svgp_predict`` at the training inputs: exactly 2 K5 launches (K_mm
    with its jitter floor, K_mx), MSE on the first 20,000 rows < 0.02,
    var ≥ 0, μ and var against ``svgp_predict`` in float64 on the card at
    the same parameters and K_mm jitter (phase 19's limits); K5 held
    against its plain version at both shapes; 5 more steps under
    ``torch.cuda.set_sync_debug_mode("error")``;
29. example 06 at the dense route's top: ``pathwise_posterior_samples`` of
    Matérn-5/2~s at N = 20,000, 64 paths at 1,000 points, 2,048 features,
    300 CG iterations: exactly 2 K6 launches (K + (σ² + jitter)·I, K_s),
    the sample mean and variance against the facade's float64 dense
    posterior (``pathwise_gates``: limits and why in ``PERF.md`` §5), K6
    held against its plain version at both shapes;
30. example 10: ``greedy_kernel_search`` on ``data/d2_mauna_loa.csv``
    (read by the port's ``load_named``, min-max normalised, the first 80%
    for training), max_depth=2, restarts=2, steps=150, in float64: BIC
    trace, structure, candidates, wall, held-out MSE through the facade's
    posterior; the score ≤ the best base kernel's, every BIC finite;
31. 8 copies of one 4,000-row problem through ``fit(method="auto")`` as
    batched input against ``fit`` on the one problem, in float64:
    parameters and NLL within 1e-3 relative, wall and peak memory;
32. BASELINE config 3 (``benchmarks/run_all.py:164-260``):
    ``nuts_chains`` of 8 chains over the Matérn-5/2~s hyperposterior of
    ``synth_se(n=1000, 0.2, 0.1, seed=0)`` (``make_stacked_nll``, the
    N(0, 3²) prior on the unconstrained leaves) in float64, from the
    defaults + 0.1·N(0, 1), 300 warmup transitions and 300 draws at
    max_depth 6, then 2 ``nuts_chains_resume`` segments of 300 (r4 ran 4;
    cut for the time limit, as ``hmc_chains``' draws): samples/s
    of both, accept, divergences, leapfrogs per draw, host reads per
    transition (the synchronisations counted under
    ``set_sync_debug_mode("warn")`` against the doublings), split-R̂ and
    ESS per parameter, peak memory; gated (``NUTS_*``), and held against
    ``hmc_chains`` (300 + 100, 16 leapfrogs) on the same target; one
    transition on the card against the CPU with the same draws; one under
    ``gpt.trace``: device busy share, launches and ms per leapfrog;
33. ``compat.get_metric`` for every family at n = 4,096 in float32 against
    float64 on the card (``M11_RTOL``), a ``DataInput`` split and
    ``subset_smoothed_grid`` on the card against the CPU;
34-36. the multi-GPU slice, each over P = 2 gloo ranks sharing the card
    (NCCL refuses two ranks on one GPU) and P = 1 over NCCL, one spawn
    (``parallel.meshes.launch``) of ``_rank_multi_gpu`` per configuration,
    the gates taken here with each limit beside its reading:
    34. ``fit_iterative(mesh=…)`` at N = 200,000 (phase 25's data and
        knobs, the constant + linear mean), 5 Adam steps, then
        ``iterative_posterior_chunked(mesh=…)`` at 256 points: NLL history
        within 1e-3 and parameters within 1e-2 of the same steps on the
        same probes in this process, P = 1 NCCL within 1e-5 of it, phase
        25's residual (≤ 1e-3) and RMSE (< 0.01) gates, no step skipped,
        K1 and K2 launched on every rank (per-rank launches, seconds per
        step, peak memory); the Mauna Loa composite's mesh matvec and
        VJP at n = 20,000 against K3/K4 in this process (K3_RTOL);
    35. the block-cyclic exact GP at n = 32,768 (SE ℓ 0.1, σ² 1e-2), each
        rank building only its block-rows through K5, all in float32 as a
        user calls it (block 512): ``distributed_nll`` on those block-rows,
        factored in place, within 1e-4 of a float64 dense Cholesky of the
        same K, and the rank's peak memory after it within 1.25 times its
        block-rows; ``distributed_posterior`` at 64 points within phase
        19's gates; 3 steps of ``fit_distributed`` with 8 probes (a finite
        history that ends below its start), on P = 2 gloo ranks and on
        P = 1 over NCCL; P = 1 NCCL within 1e-5 of P = 2 gloo on the
        float32 NLL and fit history and on the NLL and posterior run
        again on float64 inputs (float32's μ and var, where the two
        factorisations round apart, printed);
    36. config 3's log posterior (n = 1,000, Matérn-5/2, float64):
        ``hmc_chains_collective`` (100 + 100 × 16 leapfrogs) and
        ``nuts_chains_collective`` (100 + 100, max_depth 6), one chain per
        rank: the bitwise-same step size on every rank, finite log-probs,
        accept in [0.6, 0.95], and at P = 1 the result of ``hmc_chains``
        / ``nuts_chains`` with C = 1 on the same draws within 1e-8.

Each path's launch counts (all six kernels) are set to 0 just before it
is driven and read just after. The second-to-last line, after the card's
name and power limit, is one JSON object that lists the six kernels:
launches on the main paths (``launches``: the sum; ``launches_by_path``:
the SE posterior of phase 5, the SE fit of phase 8, the composite fit of
phase 14, the composite posterior of phase 15, the dense posteriors of
phase 19, the segmented and partitioned paths of phases 20 and 21, the
ChangePoint posterior of phase 23, the 50k gate of phase 24, the 200k fit
and posterior of phase 25, the Nyström posteriors of phase 26, the SVGP
predict of phase 28, the pathwise draws of phase 29, the search of phase
30, the batched fit of phase 31, the NUTS and HMC chains of phase 32,
the metrics of phase 33, and phases 34-36's ``mesh_fit_200k``,
``mesh_posterior_200k``, ``block_cyclic_32k``, ``fit_distributed_32k``
and ``mcmc_collective``, summed over the P = 2 gloo ranks, each rank's
count in ``launches_by_rank``), the largest absolute and relative
differences from the plain version over the checks (relative: K1's, K3's,
K5's and K6's max|diff| / max|ref|, K2's per scalar, K4's per parameter
array), the kernel's and the plain version's times at the main path's
shapes (K1 and K3 at r = 256; both also at r = 1 and 9 in
``ms_by_width``, beside ``bound_ms_by_width``; K5 and K6 at the 16,384²
build in device time, every shape of phase 22 in ``ms_by_shape`` and its
neighbours, the per-call wall in ``call_ms_by_shape``; K2
and K4 at r = 273, with ``product_tflops``, the rate of their
2·n1·n2·r-operation cotangent product), and the bound: the larger of the
bytes the function must move over 3.35 TB/s and its operations over
their peak -- a rank-r product of
n1·n2 pairs (K1-K4) as 3·2·n1·n2·r tensor-core operations at the 495
TFLOP/s of dense TF32 (the 3xTF32 split that keeps float32's digits), a
Gram as 3·n·m·d float32 operations at 67 TFLOP/s; the special-function
calls per pair -- one exponential for K1, K2, K5 and K6; for K3 and K4 the
calls the expression needs (``_special_calls``) -- at 132 SMs × 16 per
clock × 1.98 GHz. The last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device it fails.
"""
from __future__ import annotations

import copy
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

N_MAIN = 100_000
T_MAIN = 1_000
NOISE = 1e-2
LENGTHSCALE = 0.1
FIT_STEPS = 10
# the JAX package's 100k fit story (benchmarks/bench_100k_story.py), minus
# its TPU program-size knobs
FIT_KWARGS = dict(method="auto", optimize_noise=True, noise=1e-2, lr=0.05,
                  steps=FIT_STEPS,
                  iterative_kwargs={"max_iters": 25, "precond_m": 256,
                                    "tol": 3e-3, "early_exit": False})
R_MAIN = 2 * 8 + 256 + 1  # K2's rank: 8 probes, m = 256
R_CG = 1 + 8  # K1's width in the fit's CG: y and 8 probes
# K2's limit per scalar against the float64 plain version on a zero-mean
# cotangent, whose sums cancel (the JAX gate's 1e-3 is for one that does not)
K2_RTOL_CANCEL = 1e-4

# peaks of one H100 SXM (NVIDIA's data sheet; the special-function rate is
# the CUDA programming guide's 16 per clock per SM at the 1.98 GHz boost)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12  # dense tensor-core TF32
EXP_PER_S = 132 * 16 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"f32_precision={torch.get_float32_matmul_precision()}")
    return smi


def phase_build() -> None:
    """Every kernel the smoke runs, one nvcc for each library, all started
    together: K1 and K2 from their sources, and K3 and K4 generated for
    every expression of the composite phases."""
    from gaussianprocessfundamentals_tpu_torch.ops import (
        cuda_build,
        cuda_dense_gram,
        cuda_expr,
        cuda_gram,
        cuda_lrvjp,
    )

    def timed(fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0

    sources = ("gram_matvec.cu", "lowrank_vjp.cu", "dense_gram.cu")
    exprs = [(k, d) for _, k, d in _expr_cases()]
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        futures = [pool.submit(timed, cuda_build.build, src) for src in sources]
        futures.append(pool.submit(timed, cuda_expr.prebuild, exprs))
        seconds = [f.result() for f in futures]
    cuda_gram._lib()
    cuda_lrvjp._lib()
    cuda_dense_gram._lib()
    for source, dt in zip(sources, seconds):
        log(f"[build] {source} -> {cuda_build.library_path(source).name} "
            f"in {dt:.2f} s")
    log(f"[build] K3 and K4 for {len(exprs)} expressions "
        f"({2 * len(exprs)} libraries, csrc/expr_matvec.cu and "
        f"csrc/expr_vjp.cu with generated code) in {seconds[-1]:.2f} s")
    spills = _ptxas_lines(cuda_build.library_path("gram_matvec.cu"), "K1")
    spills += _ptxas_lines(cuda_build.library_path("lowrank_vjp.cu"), "K2")
    spills += _ptxas_lines(cuda_build.library_path("dense_gram.cu"), "K5/K6")
    for name, kernel, d in _expr_cases():
        spills += _ptxas_lines(cuda_expr.library("matvec", _core(kernel), d),
                               f"K3 {name}")
        spills += _ptxas_lines(cuda_expr.library("vjp", _core(kernel), d),
                               f"K4 {name}")
    if spills:
        raise RuntimeError(f"kernel instantiations spill registers: {spills}")


def _ptxas_lines(library, tag: str) -> list:
    """Print ``-Xptxas -v``'s registers, stack and spills of each kernel of
    a library (names demangled with cu++filt where it is found), with K1's
    and K3's column tile, or the blocks of K2's, K4's, K5's and K6's 256
    threads that the register file holds on an SM; returns the names of
    those that spill."""
    from gaussianprocessfundamentals_tpu_torch.ops import cuda_build

    report = cuda_build.ptxas_report(library)
    try:
        filt = str(Path(cuda_build._nvcc()).parent / "cu++filt")
        names = subprocess.run(
            [filt, *(k["name"] for k in report)], capture_output=True,
            text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = [k["name"] for k in report]
    spilled = []
    wide = any("(int)32>" in name or "ELi32E" in name for name in names)
    per_block = not tag.startswith(("K1", "K3"))
    if not per_block:
        tag += f" ({256 if wide else 128}-column tiles)"
    for k, name in zip(report, names):
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = name[:name.find(">(") + 1] if ">(" in name else name
        spill = k.get("spill_stores", 0) + k.get("spill_loads", 0)
        regs = -(-k.get("registers", 255) // 8) * 8  # allocated in 8s
        per_sm = (f" ({min(8, 65536 // (256 * regs))} block(s) per SM)"
                  if per_block else "")
        log(f"[ptxas] {tag}{per_sm} {name}: {k.get('registers')} registers, "
            f"{k.get('stack')} bytes stack, {k.get('spill_stores')} bytes "
            f"spill stores, {k.get('spill_loads')} bytes spill loads")
        if spill:
            spilled.append(f"{tag} {name}")
    return spilled


def phase_kernel_check() -> tuple[float, float]:
    """K1 against its plain version on the card; returns the largest
    absolute and relative differences over every case."""
    g = torch.Generator().manual_seed(1)
    n1, n2 = 3000, 5001
    worst = (0.0, 0.0)
    cases = [("se", 1, 0.1, 1.3, 5e-5), ("mat32", 1, 0.2, 0.7, 5e-5),
             ("mat52", 1, 0.2, 0.7, 5e-5), ("se", 3, 0.4, 1.3, 5e-4)]
    for kind, d, ls, var, rtol in cases:
        x1 = torch.rand(n1, d, generator=g).cuda()
        x2 = torch.rand(n2, d, generator=g).cuda()
        for r in (1, 8, 9, 16, 64, 255, 256, 257):
            V = torch.randn(n2, r, generator=g).cuda()
            worst = _worse(worst, _check_against_plain(x1, x2, V, ls, var,
                                                       kind, rtol))
    return worst


def _worse(a, b):
    """Elementwise max of two (max_abs_err, max_rel_err) pairs."""
    return max(a[0], b[0]), max(a[1], b[1])


def _check_against_plain(x1, x2, V, ls, var, kind, rtol,
                         f64=False, vs_f64=False) -> tuple[float, float]:
    """K1 against its plain version on the same inputs: max|diff| must be
    within ``rtol`` of max|ref| (the JAX package's on-chip gates: 5e-5 at
    d = 1, 5e-4 at SE d = 3). With ``f64``, also print both versions'
    distance from the plain version run in float64; with ``vs_f64``, hold
    the kernel to that float64 version instead. Returns max|diff| and
    max|diff| / max|ref|."""
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
        fused_gram_matvec_cross,
        plain_gram_matvec_cross,
    )

    got = fused_gram_matvec_cross(x1, x2, V, ls, var, kind)
    torch.cuda.synchronize()
    ref = plain_gram_matvec_cross(x1, x2, V, ls, var, kind)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tag = f"{kind} d={x1.shape[1]} n1={x1.shape[0]} n2={x2.shape[0]} r={V.shape[1]}"
    extra = ""
    if f64 or vs_f64:
        ref64 = plain_gram_matvec_cross(x1.double(), x2.double(), V.double(),
                                        ls, var, kind)
        err64 = float((got.double() - ref64).abs().max())
        extra = (f"; vs float64: kernel {err64:.3e}, "
                 f"plain {float((ref.double() - ref64).abs().max()):.3e}")
        if vs_f64:
            err, scale = err64, float(ref64.abs().max())
            tag += " vs float64"
    ok = bool(torch.isfinite(got).all()) and err <= rtol * scale
    log(f"[k1] {tag}: max|diff| {err:.3e} (limit {rtol:g} x max|ref| {scale:.3e})"
        f"{extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"K1 disagrees with its plain version: {tag}")
    return err, err / scale


def _data(n: int, seed: int, device: str):
    g = torch.Generator().manual_seed(seed)
    x = torch.sort(torch.rand(n, 1, generator=g), dim=0).values
    y = torch.sin(8.0 * x[:, 0]) + 0.1 * torch.randn(n, generator=g)
    return x.to(device), y.to(device)


def _se_kernel():
    import gaussianprocessfundamentals_tpu_torch as gpt

    kernel = gpt.SquaredExponentialKernel()
    # hyperparameters as a JAX checkpoint carries them
    gpt.params_from_numpy(kernel, {"['lengthscale']": np.float32(LENGTHSCALE)})
    return kernel


def phase_oracle() -> None:
    import gaussianprocessfundamentals_tpu_torch as gpt

    n, t = 4096, 64
    x, y = _data(n, seed=2, device="cuda")
    xt = torch.linspace(0.01, 0.99, t, device="cuda")[:, None]
    gp = gpt.GaussianProcess(_se_kernel(), noise=NOISE, device="cuda").set_data(x, y)
    post = gp.posterior(xt, method="iterative")
    gp64 = gpt.GaussianProcess(_se_kernel(), noise=NOISE, device="cuda").set_data(
        x.double(), y.double())
    ref = gp64.posterior(xt.double(), method="dense")
    torch.cuda.synchronize()
    mu_err = float((post.mean.double() - ref.mean).abs().max())
    mu_lim = 1e-3 * float(ref.mean.abs().max())
    var_err = float((post.var.double() - ref.var).abs().max())
    var_lim = 1e-3 * 1.0  # k_ss = 1 for the unscaled SE kernel
    ok = mu_err <= mu_lim and var_err <= var_lim
    log(f"[oracle] n={n} t={t}: mu max|diff| {mu_err:.3e} (limit {mu_lim:.3e}), "
        f"var max|diff| {var_err:.3e} (limit {var_lim:.1e}) vs f64 dense "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("iterative posterior disagrees with the f64 dense oracle")


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _abba_ms(kernel_fn, plain_fn, reps: int):
    """Kernel and plain times in turns: plain, kernel, kernel, plain."""
    p1 = _time_ms(plain_fn, reps)
    k1 = _time_ms(kernel_fn, reps)
    k2 = _time_ms(kernel_fn, reps)
    p2 = _time_ms(plain_fn, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_main() -> dict:
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
        fused_gram_matvec,
        plain_gram_matvec_cross,
    )

    x, y = _data(N_MAIN, seed=0, device="cuda")
    xt = torch.linspace(0.01, 0.99, T_MAIN, device="cuda")[:, None]
    gp = gpt.GaussianProcess(_se_kernel(), noise=NOISE, device="cuda").set_data(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    post = gp.posterior(xt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    launches = counts["K1"]
    peak = torch.cuda.max_memory_allocated()
    chunks = -(-T_MAIN // 256)

    stats = post.solve_stats
    truth = torch.sin(8.0 * xt[:, 0])
    rmse = float(torch.sqrt(torch.mean((post.mean - truth) ** 2)))
    finite = bool(torch.isfinite(post.mean).all() and torch.isfinite(post.var).all())
    nonneg = bool((post.var >= 0).all())
    shapes = tuple(post.mean.shape) == (T_MAIN,) and tuple(post.var.shape) == (T_MAIN,)
    log(f"[main] N={N_MAIN} t={T_MAIN} posterior(method='auto'): wall {wall:.3f} s, "
        f"CG iters {stats['iters']}, true rel resid "
        f"{[float(f'{r:.3e}') for r in stats['rel_resid']]}, "
        f"K1 launches {launches}, K5 launches {counts['K5']} (one per K_s "
        f"chunk), peak mem {peak / 1e9:.3f} GB, "
        f"mean RMSE vs sin(8x) {rmse:.5f}, var range "
        f"[{float(post.var.min()):.3e}, {float(post.var.max()):.3e}]")
    checks = {
        "K1 launched": launches > 0,
        f"K5 launched once per chunk ({chunks})": counts["K5"] == chunks,
        "finite, shape": finite and shapes,
        "var >= 0": nonneg,
        "max rel CG resid < 1e-3": max(stats["rel_resid"]) < 1e-3,
        "mean RMSE < 0.01": rmse < 0.01,
        "peak memory < 4 GB": peak < 4e9,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"main path checks failed: {failed}")

    # K1 against the plain version at the main path's shapes (n = 100k)
    g = torch.Generator().manual_seed(3)
    times, worst = {}, (0.0, 0.0)
    for r in (1, 256):
        V = torch.randn(N_MAIN, r, generator=g).cuda()
        worst = _worse(worst, _check_against_plain(
            x, x, V, LENGTHSCALE, 1.0, "se", 5e-5, f64=True))
        reps = 10 if r == 1 else 3
        times[r] = _abba_ms(
            lambda: fused_gram_matvec(x, V, LENGTHSCALE, 1.0, "se"),
            lambda: plain_gram_matvec_cross(x, x, V, LENGTHSCALE, 1.0, "se"),
            reps,
        )
        bound_ms, bound_by = _bound(N_MAIN, N_MAIN, r, 4 * N_MAIN * (2 + r),
                                    4 * N_MAIN * r)
        times[r] += (bound_ms, bound_by)
        log(f"[time] K1 r={r} n={N_MAIN}: kernel {times[r][0]:.3f} ms, "
            f"plain {times[r][1]:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}): "
            f"{100 * bound_ms / times[r][0]:.1f}% of the bound "
            f"({2 * N_MAIN * N_MAIN * r / (times[r][0] * 1e-3) / 1e12:.2f} TFLOP/s "
            f"in the kernel's product)")
    # chain length: every total runs over all 100k x2 rows, against float64
    V = torch.randn(N_MAIN, 256, generator=g).cuda()
    worst = _worse(worst, _check_against_plain(
        _chain_rows(x), x, V, LENGTHSCALE, 1.0, "se", K3_RTOL, vs_f64=True))
    return {"counts": counts, "times": times, "worst": worst}


def _chain_rows(x):
    """2,048 rows of x spread over its range (every 48th of the sorted
    100k), so each row's pairs reach across the whole of x."""
    return x[::48][:2048]


def _bound(n1: int, n2: int, r: int, in_bytes: int, out_bytes: int,
           n_special: int = 1):
    """(bound_ms, bound_by) of a kernel over n1·n2 pairs with a rank-r
    product: the larger of its bytes over the memory rate, its
    special-function calls over their rate, and the product's 3xTF32
    tensor-core operations (3·2·n1·n2·r) over their peak (module
    docstring)."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = max(3 * 2.0 * n1 * n2 * r / TF32_OPS_PER_S,
                n1 * n2 * n_special / EXP_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def _k2_check(x1, x2, U, W, ls, var, kind, rtol,
              f64=False) -> tuple[float, float]:
    """K2 against its plain version on the same inputs (the plain version
    run in float64 with ``f64``): each scalar within ``rtol`` relative.
    Returns the largest absolute and relative differences."""
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_lrvjp import (
        fused_lowrank_vjp_cross,
        plain_lowrank_vjp_cross,
    )

    got = fused_lowrank_vjp_cross(x1, x2, U, W, ls, var, kind)
    torch.cuda.synchronize()
    args = (x1, x2, U, W)
    if f64:
        args = tuple(a.double() for a in args)
    ref = plain_lowrank_vjp_cross(*args, ls, var, kind)
    torch.cuda.synchronize()
    errs = [abs(float(a) - float(b)) for a, b in zip(got, ref)]
    rels = [e / abs(float(b)) for e, b in zip(errs, ref)]
    extra = ""
    if f64:
        ref32 = plain_lowrank_vjp_cross(x1, x2, U, W, ls, var, kind)
        extra = "; plain float32 vs f64 rel err " + " ".join(
            f"{abs(float(a) - float(b)) / abs(float(b)):.2e}"
            for a, b in zip(ref32, ref))
    ok = all(bool(torch.isfinite(a)) for a in got) and max(rels) <= rtol
    tag = (f"{kind} d={x1.shape[1]} n1={x1.shape[0]} n2={x2.shape[0]} "
           f"r={U.shape[1]} cot mean {float(U.mean()):+.2f}")
    log(f"[k2] {tag}: (g_ls, g_var) {float(got[0]):.6e} {float(got[1]):.6e} "
        f"vs plain{' f64' if f64 else ''} {float(ref[0]):.6e} "
        f"{float(ref[1]):.6e}: rel err {rels[0]:.2e} {rels[1]:.2e} "
        f"(limit {rtol:g}){extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"K2 disagrees with its plain version: {tag}")
    return max(errs), max(rels)


def _cotangent(n1: int, n2: int, r: int, g, shift: float):
    """U [n1, r] and W [n2, r], standard normal plus ``shift``.

    With shift 0.5 (the JAX gate's regime) every pair's cotangent is about
    0.25·r, so the sums do not cancel, but they hardly depend on how rows
    and columns of U and W are paired. With shift 0 the cotangent has mixed
    signs and cancels heavily, as the fit's own does: a kernel that pairs a
    column of U with the wrong column of W, or misplaces a row, lands far
    from the plain version. Those checks use the plain version in float64.
    """
    return ((shift + torch.randn(n1, r, generator=g)).cuda(),
            (shift + torch.randn(n2, r, generator=g)).cuda())


def phase_k2_check() -> tuple[float, float]:
    g = torch.Generator().manual_seed(4)
    n1, n2 = 3000, 5001
    worst = (0.0, 0.0)
    # SE at d = 20 and 40 takes K2's run-time width (a part chunk of 32
    # dimensions)
    for kind, d, ls, var in (("se", 1, 0.1, 1.3), ("mat32", 1, 0.2, 0.7),
                             ("mat52", 1, 0.2, 0.7), ("se", 3, 0.4, 1.3),
                             ("se", 20, 0.9, 1.3), ("se", 40, 1.3, 1.3)):
        x1 = torch.rand(n1, d, generator=g).cuda()
        x2 = torch.rand(n2, d, generator=g).cuda()
        for r in (1, 17, 145, R_MAIN):
            U, W = _cotangent(n1, n2, r, g, 0.5)
            worst = _worse(worst, _k2_check(x1, x2, U, W, ls, var, kind, 1e-3))
        U, W = _cotangent(n1, n2, R_MAIN, g, 0.0)
        worst = _worse(worst, _k2_check(x1, x2, U, W, ls, var, kind,
                                        K2_RTOL_CANCEL, f64=True))
    # accumulation depth: 65,536² pairs against the float64 plain version
    n = 65_536
    x = torch.sort(torch.rand(n, 1, generator=g), dim=0).values.cuda()
    U, W = _cotangent(n, n, 17, g, 0.5)
    for kind in ("se", "mat52"):
        worst = _worse(worst, _k2_check(x, x, U, W, 0.1, 1.2, kind, 3e-3,
                                        f64=True))
    return worst


def _trend_data(n: int, seed: int):
    """The JAX package's 100k fit story data: sorted x ~ U(0, 1),
    y = 2 + 3x + sin(8x) + 0.1ε."""
    g = torch.Generator().manual_seed(seed)
    x = torch.sort(torch.rand(n, 1, generator=g), dim=0).values
    y = (2.0 + 3.0 * x[:, 0] + torch.sin(8.0 * x[:, 0])
         + 0.1 * torch.randn(n, generator=g))
    return x.cuda(), y.cuda()


def phase_fit_oracle() -> None:
    """One streamed iterative NLL + gradient against the float64 dense ones
    (the tolerances of tests/test_iterative.py: NLL rtol 0.02, ℓ gradient
    rtol 0.15)."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
        fused_gram_matvec_cross,
    )
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_lrvjp import (
        fused_lowrank_vjp_cross,
    )

    n = 4096
    x, y = _data(n, seed=5, device="cuda")
    kernel = gpt.SquaredExponentialKernel(scaled=True).set_params({
        "lengthscale": torch.tensor(LENGTHSCALE),
        "variance": torch.tensor(1.0)}).cuda()
    fused_gram_matvec_cross.launches = 0
    fused_lowrank_vjp_cross.launches = 0
    nll, g, g_noise, resid = gpt.iterative_nll_and_grad(
        kernel, x, y, NOISE, torch.Generator(device="cuda").manual_seed(0),
        num_probes=64, max_iters=100, tol=1e-4, precond_m=256,
        materialize=False)
    torch.cuda.synchronize()
    k1, k2 = fused_gram_matvec_cross.launches, fused_lowrank_vjp_cross.launches

    k64 = gpt.SquaredExponentialKernel(scaled=True).set_params({
        "lengthscale": torch.tensor(LENGTHSCALE, dtype=torch.float64),
        "variance": torch.tensor(1.0, dtype=torch.float64)}).cuda()
    x64, y64 = x.double(), y.double()
    with k64.differentiable() as p:
        ref = chol.nll(k64.gram(x64, x64), y64, NOISE, 0.0)
        g_ref = torch.autograd.grad(ref, [p["lengthscale"], p["variance"]])
    ref = ref.detach()
    nll_rel = abs(float(nll) - float(ref)) / abs(float(ref))
    ls_rel = (abs(float(g["lengthscale"]) - float(g_ref[0]))
              / abs(float(g_ref[0])))
    var_rel = abs(float(g["variance"]) - float(g_ref[1])) / abs(float(g_ref[1]))
    ok = nll_rel <= 0.02 and ls_rel <= 0.15 and k2 == 1 and k1 > 0
    log(f"[fit-oracle] n={n} streamed, 64 probes: nll {float(nll):.4f} vs f64 "
        f"dense {float(ref):.4f} (rel {nll_rel:.2e}, limit 0.02); g_ls "
        f"{float(g['lengthscale']):.4f} vs {float(g_ref[0]):.4f} (rel "
        f"{ls_rel:.2e}, limit 0.15); g_var rel {var_rel:.2e}; max rel CG "
        f"resid {float(resid.max()):.2e}; K1 launches {k1}, K2 launches {k2} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("iterative NLL + gradient disagree with the f64 "
                           "dense oracle, or K2 did not run exactly once")


def _fit_model():
    import gaussianprocessfundamentals_tpu_torch as gpt

    return gpt.GaussianProcess(gpt.SquaredExponentialKernel(scaled=True),
                               gpt.ConstantMean() + gpt.LinearMean(dim=1),
                               device="cuda")


def phase_fit() -> dict:
    x, y = _trend_data(N_MAIN, seed=6)
    gp = _fit_model()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    res = gp.fit(x, y, **FIT_KWARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    k1, k2 = counts["K1"], counts["K2"]
    peak = torch.cuda.max_memory_allocated()

    hist = [float(v) for v in res.history]
    frozen = res.diagnostics["frozen_frac"]
    c = float(res.mean_params["children"][0]["c"])
    slope = float(res.mean_params["children"][1]["slope"][0])
    xt = torch.linspace(0.01, 0.99, T_MAIN, device="cuda")[:, None]
    post = gp.posterior(xt)
    torch.cuda.synchronize()
    truth = 2.0 + 3.0 * xt[:, 0] + torch.sin(8.0 * xt[:, 0])
    rmse = float(torch.sqrt(torch.mean((post.mean - truth) ** 2)))
    log(f"[fit] N={N_MAIN} fit(method='auto'), {FIT_STEPS} Adam steps: wall "
        f"{wall:.3f} s, {wall / FIT_STEPS:.3f} s/step (first step included), "
        f"K1 launches {k1}, K2 launches {k2}, peak mem {peak / 1e9:.3f} GB")
    log(f"[fit] NLL history {[float(f'{v:.2f}') for v in hist]}; frozen_frac "
        f"{frozen}; noise {float(res.noise):.5f}, lengthscale "
        f"{float(res.kernel_params['lengthscale']):.5f}, variance "
        f"{float(res.kernel_params['variance']):.5f}, const {c:.4f}, slope "
        f"{slope:.4f}; posterior at {T_MAIN} points: mean RMSE vs the noise-"
        f"free function {rmse:.4f}, var range [{float(post.var.min()):.3e}, "
        f"{float(post.var.max()):.3e}]")
    checks = {
        f"K2 launches == {FIT_STEPS}": k2 == FIT_STEPS,
        "K1 launched": k1 > 0,
        "NLL history finite": all(np.isfinite(hist)),
        "last NLL below first": hist[-1] < hist[0],
        "frozen_frac == 0": frozen == 0.0,
        "peak memory < 8 GB": peak < 8e9,
        "posterior finite": bool(torch.isfinite(post.mean).all()
                                 and torch.isfinite(post.var).all()),
        "posterior var >= 0": bool((post.var >= 0).all()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"training path checks failed: {failed}")
    return {"counts": counts, "x": x, "y": y}


def _as_main_path(U, W):
    """U and W as the NLL hands them to K2 and K4: zero columns up to a
    width that is a multiple of 4 (``models.iterative.cotangent_factor``),
    which lets the kernels copy rows 16 bytes at a time."""
    from gaussianprocessfundamentals_tpu_torch.models.iterative import (
        cotangent_factor,
    )

    return cotangent_factor([U]), cotangent_factor([W])


def _same(a, b) -> bool:
    return all(torch.equal(p, q) for p, q in zip(a, b))


def phase_fit_time(x) -> dict:
    """K2, then K1 at the CG width, in turns with their plain versions at
    the training path's shapes (K2's U and W with the NLL's zero columns;
    K2 on the unpadded ragged r = 273 timed in turns with that); returns
    K2's numbers."""
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
        fused_gram_matvec,
        plain_gram_matvec_cross,
    )
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_lrvjp import (
        fused_lowrank_vjp,
        plain_lowrank_vjp_cross,
    )

    g = torch.Generator().manual_seed(7)
    U, W = _cotangent(N_MAIN, N_MAIN, R_MAIN, g, 0.5)
    worst = _k2_check(x, x, U, W, LENGTHSCALE, 1.0, "se", 1e-3)
    U, W = _cotangent(N_MAIN, N_MAIN, R_MAIN, g, 0.0)
    worst = _worse(worst, _k2_check(x, x, U, W, LENGTHSCALE, 1.0, "se",
                                    K2_RTOL_CANCEL, f64=True))
    Up, Wp = _as_main_path(U, W)

    def k2(U, W):
        return fused_lowrank_vjp(x, U, W, LENGTHSCALE, 1.0, "se")

    same = _same(k2(U, W), k2(Up, Wp))
    log(f"[k2] r={R_MAIN} padded to {Up.shape[1]} by zero columns (16-byte "
        f"copies) gives bit for bit the unpadded (4-byte copies) sums: {same}")
    if not same:
        raise RuntimeError("K2: the zero columns change the sums")
    ms, plain_ms = _abba_ms(
        lambda: k2(Up, Wp),
        lambda: plain_lowrank_vjp_cross(x, x, Up, Wp, LENGTHSCALE, 1.0, "se"),
        3,
    )
    ragged_ms, padded_ms = _abba_ms(lambda: k2(U, W), lambda: k2(Up, Wp), 3)
    bound_ms, bound_by = _bound(N_MAIN, N_MAIN, R_MAIN,
                                4 * 2 * N_MAIN * (1 + Up.shape[1]), 8)
    log(f"[time] K2 r={R_MAIN} (+{Up.shape[1] - R_MAIN} zero columns, as the "
        f"NLL makes it) n={N_MAIN}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}): "
        f"{100 * bound_ms / ms:.1f}% of the bound "
        f"({2 * N_MAIN * N_MAIN * R_MAIN / (ms * 1e-3) / 1e12:.2f} TFLOP/s in "
        f"the kernel's product); unpadded r={R_MAIN} (4-byte copies) "
        f"{ragged_ms:.3f} ms against {padded_ms:.3f} ms padded, in turns")
    # K1 at the fit's CG width: y and 8 probes, over all 782 x2 tiles
    V = torch.randn(N_MAIN, R_CG, generator=g).cuda()
    k1_worst = _check_against_plain(x, x, V, LENGTHSCALE, 1.0, "se", 5e-5,
                                    f64=True)
    k1_ms, k1_plain_ms = _abba_ms(
        lambda: fused_gram_matvec(x, V, LENGTHSCALE, 1.0, "se"),
        lambda: plain_gram_matvec_cross(x, x, V, LENGTHSCALE, 1.0, "se"),
        10,
    )
    k1_bound_ms, k1_bound_by = _bound(N_MAIN, N_MAIN, R_CG,
                                      4 * N_MAIN * (2 + R_CG), 4 * N_MAIN * R_CG)
    log(f"[time] K1 r={R_CG} n={N_MAIN}: kernel {k1_ms:.3f} ms, plain "
        f"{k1_plain_ms:.3f} ms, bound {k1_bound_ms:.3f} ms ({k1_bound_by}): "
        f"{100 * k1_bound_ms / k1_ms:.1f}% of the bound")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "worst": worst, "k1_worst": k1_worst,
            "k1": (k1_ms, k1_plain_ms, k1_bound_ms, k1_bound_by)}


def phase_profile(x, y) -> None:
    """The SE fit of phase 8 again, warm (the first fit in a process pays
    one-time set-up: library handles, lazy kernel loading), then one of its
    steps profiled."""
    t0 = time.perf_counter()
    _fit_model().fit(x, y, **FIT_KWARGS)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    log(f"[profile] warm fit at N={N_MAIN}, {FIT_STEPS} steps: wall {warm:.3f} s, "
        f"{warm / FIT_STEPS:.3f} s/step")
    _profile_step(_fit_model, x, y, "profile")


def _device_busy(prof, skip=()) -> tuple:
    """(CUDA kernel events, the union of their intervals in µs) of a
    ``torch.profiler`` run; ``skip`` names ranges labelled on the device
    timeline (``record_function``), which are not kernels."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.name not in skip)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return len(spans), busy


def _profile_step(make_gp, x, y, tag: str) -> None:
    """One fit step under torch.profiler: device time by kernel, and the
    union of the device's kernel intervals over the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kw = dict(FIT_KWARGS, steps=1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        make_gp().fit(x, y, **kw)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    n_kernels, busy = _device_busy(prof)
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"[{tag}] one fit step at N={N_MAIN}: wall {wall_us / 1e3:.1f} ms, "
        f"{n_kernels} device kernels, device busy {busy / 1e3:.1f} ms "
        f"({100 * busy / wall_us:.1f}% of wall, idle "
        f"{100 * (1 - busy / wall_us):.1f}%)")
    for name, us in top:
        log(f"[{tag}]   {us / 1e3:9.2f} ms  {name[:100]}")


# --- the composite kernel expression: K3 and K4 ------------------------------

# the JAX package's flagship composite (examples/02_mauna_loa_composite.py)
# at the knobs of the SE fit story above
MAUNA_N_ORACLE = 4096
K3_RTOL = 5e-5  # the JAX gates expr_matvec_mauna / expr_matvec_ard_d3
K4_RTOL = 3e-3  # the JAX gate expr_vjp_mauna, per parameter array
# K4 against the float64 plain version on the zero-mean cotangent: 14x the
# worst error measured on one H100 over phases 12 and 16 (1.4e-5, the
# composite's first variance at n = 100k), below the float32 plain
# version's own error on the sharp PER cases (up to 0.65), far below the
# O(1) of a mispaired row or column of U and W
K4_RTOL_F64 = 2e-4


def _mauna_kernel():
    import gaussianprocessfundamentals_tpu_torch as gpt

    return (gpt.SquaredExponentialKernel(scaled=True) * gpt.PeriodicKernel()
            + gpt.SquaredExponentialKernel(scaled=True) + gpt.LinearKernel()
            + gpt.WhiteNoiseKernel(scaled=True))


def _mauna_series(t):
    """The JAX package's ``synth_mauna_loa`` formula without its noise:
    trend + two seasonal harmonics, t in years."""
    return (315.0 + 0.8 * (t - 1958.0) + 0.012 * (t - 1958.0) ** 2
            + 3.0 * np.sin(2 * np.pi * t) + 0.8 * np.sin(4 * np.pi * t))


def _mauna_data(n: int, n_test: int = 0):
    """n monthly-shaped points of the Mauna Loa series over 1958-2018 with
    the formula's 0.3 noise (seed 42), x and y min-max normalised to [0, 1]
    as ``DataInput.from_arrays`` does; and ``n_test`` noise-free points
    midway between training points, normalised the same way."""
    t = np.linspace(1958.0, 2018.0, n)
    y = _mauna_series(t) + 0.3 * np.random.default_rng(42).standard_normal(n)
    t0, dt, y0, dy = t.min(), t.max() - t.min(), y.min(), y.max() - y.min()
    x = torch.tensor((t - t0) / dt, dtype=torch.float32)[:, None].cuda()
    yn = torch.tensor((y - y0) / dy, dtype=torch.float32).cuda()
    idx = np.linspace(0, n - 2, n_test).astype(np.int64)
    tt = 0.5 * (t[idx] + t[idx + 1])
    xt = torch.tensor((tt - t0) / dt, dtype=torch.float32)[:, None].cuda()
    truth = torch.tensor((_mauna_series(tt) - y0) / dy,
                         dtype=torch.float32).cuda()
    return x, yn, xt, truth


def _tensors(tree):
    """A params tree of floats and lists as float32 tensors (a list is one
    per-dimension vector)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tensors(v) for v in tree)
    return torch.tensor(tree, dtype=torch.float32)


def _with_params(kernel, params):
    """``kernel`` on the card holding ``params``."""
    return kernel.set_params(_tensors(params)).cuda()


MAUNA_PARAMS = {"children": (
    {"children": ({"lengthscale": 0.3, "variance": 0.05},
                  {"lengthscale": 0.8, "period": 0.05})},
    {"lengthscale": 0.15, "variance": 0.2},
    {"offset": [0.4]},
    {"variance": 0.02})}


def _expr_cases():
    """(name, kernel on the card, d): each leaf alone -- SE scalar and ARD
    at d = 3, PER, LIN with an ARD offset at d = 3, Matérn-3/2 and -5/2 at
    d = 1 and ARD at d = 3, RQ, CONST -- and the Mauna Loa composite."""
    import gaussianprocessfundamentals_tpu_torch as gpt

    ard = [0.2, 0.3, 0.4]
    return [
        ("se d=3", _with_params(gpt.SquaredExponentialKernel(dim=3, scaled=True),
                                {"lengthscale": 0.4, "variance": 1.3}), 3),
        ("se-ard d=3", _with_params(gpt.SquaredExponentialKernel(dim=3, scaled=True),
                                    {"lengthscale": ard, "variance": 1.3}), 3),
        ("per", _with_params(gpt.PeriodicKernel(scaled=True),
                             {"lengthscale": 0.6, "period": 0.15,
                              "variance": 0.9}), 1),
        ("lin-ard d=3", _with_params(gpt.LinearKernel(dim=3, scaled=True),
                                     {"offset": [0.1, 0.5, 0.9],
                                      "variance": 0.7}), 3),
        ("mat32", _with_params(gpt.Matern32Kernel(scaled=True),
                               {"lengthscale": 0.2, "variance": 0.7}), 1),
        ("mat32-ard d=3", _with_params(gpt.Matern32Kernel(dim=3, scaled=True),
                                       {"lengthscale": ard, "variance": 0.7}), 3),
        ("mat52", _with_params(gpt.Matern52Kernel(scaled=True),
                               {"lengthscale": 0.2, "variance": 0.7}), 1),
        ("mat52-ard d=3", _with_params(gpt.Matern52Kernel(dim=3, scaled=True),
                                       {"lengthscale": ard, "variance": 0.7}), 3),
        ("rq", _with_params(gpt.RationalQuadraticKernel(scaled=True),
                            {"lengthscale": 0.2, "alpha": 0.7,
                             "variance": 1.1}), 1),
        ("const", _with_params(gpt.ConstantKernel(scaled=True),
                               {"c": 0.8, "variance": 1.5}), 1),
        ("mauna", _with_params(_mauna_kernel(), MAUNA_PARAMS), 1),
    ]


def _core(kernel):
    from gaussianprocessfundamentals_tpu_torch.ops.expr import split_white_noise

    return split_white_noise(kernel)[0]


def _f64(kernel):
    return copy.deepcopy(kernel).double()


def _k3_check(kernel, x1, x2, V, tag, f64=False):
    """K3 against its plain version on the same inputs: max|diff| within
    K3_RTOL of max|ref|; with ``f64``, against the plain version run in
    float64 instead, the float32 plain version's own distance printed
    beside. Returns (max|diff|, max|diff| / max|ref|)."""
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_expr import (
        expr_gram_matvec_cross,
    )
    from gaussianprocessfundamentals_tpu_torch.ops.expr import (
        plain_expr_gram_matvec_cross,
    )

    got = expr_gram_matvec_cross(kernel, x1, x2, V)
    torch.cuda.synchronize()
    ref = plain_expr_gram_matvec_cross(kernel, x1, x2, V)
    torch.cuda.synchronize()
    extra = ""
    if f64:
        ref64 = plain_expr_gram_matvec_cross(_f64(kernel), x1.double(),
                                             x2.double(), V.double())
        plain_err = float((ref.double() - ref64).abs().max())
        err = float((got.double() - ref64).abs().max())
        scale = float(ref64.abs().max())
        extra = f" vs float64 (float32 plain {plain_err:.3e})"
    else:
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
    limit = K3_RTOL * scale
    ok = bool(torch.isfinite(got).all()) and err <= limit
    log(f"[k3] {tag} n1={x1.shape[0]} n2={x2.shape[0]} r={V.shape[1]}: "
        f"max|diff| {err:.3e}{extra} (limit {limit:.3e}, max|ref| "
        f"{scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"K3 disagrees with its plain version: {tag}")
    return err, err / scale


def phase_k3_check() -> tuple:
    g = torch.Generator().manual_seed(11)
    n1, n2 = 3000, 5001
    worst = (0.0, 0.0)
    for name, kernel, d in _expr_cases():
        core = _core(kernel)
        x1 = torch.rand(n1, d, generator=g).cuda()
        x2 = torch.rand(n2, d, generator=g).cuda()
        for r in (1, 8, 9, 16, 255, 256):
            V = torch.randn(n2, r, generator=g).cuda()
            worst = _worse(worst, _k3_check(core, x1, x2, V, name))
    # accumulation depth: 65,536² pairs of the Mauna composite, float64
    n = 65_536
    x = torch.sort(torch.rand(n, 1, generator=g), dim=0).values.cuda()
    V = torch.randn(n, 9, generator=g).cuda()
    mauna = _core(_expr_cases()[-1][1])
    worst = _worse(worst, _k3_check(mauna, x, x, V, "mauna", f64=True))
    x1 = torch.rand(n1, 1, generator=g).cuda()
    x2 = torch.rand(n2, 1, generator=g).cuda()
    for name, per in _sharp_per_cases():
        for r in (1, 9):
            V = torch.randn(n2, r, generator=g).cuda()
            worst = _worse(worst, _k3_check(per, x1, x2, V, name, f64=True))
    return worst


def _sharp_per_cases():
    """PER where its float32 phase π·man/p is not accurate enough (the
    kernels reduce it in float64): at its defaults (ℓ = p = range/10), at
    ℓ's lower bound 5·range/n and at the period's lower bound 10·range/n
    (n = 100k), where the phase reaches 3e4 rad."""
    import gaussianprocessfundamentals_tpu_torch as gpt

    return [(name, _with_params(gpt.PeriodicKernel(scaled=True),
                                {"lengthscale": ls, "period": p,
                                 "variance": 1.0}))
            for name, ls, p in (("per at its defaults", 0.1, 0.1),
                                ("per at ℓ = 5e-5", 5.0 / N_MAIN, 0.1),
                                ("per at period 1e-4", 1.0, 10.0 / N_MAIN))]


def _param_arrays(kernel):
    """(label, slice of the packed vector) per parameter array."""
    from gaussianprocessfundamentals_tpu_torch.ops.expr import layout

    return [(f"{kind}{i}.{name}", slice(off, off + sz))
            for i, (kind, slots, _) in enumerate(layout(kernel))
            for name, (off, sz) in slots.items()]


def _k4_check(kernel, x1, x2, U, W, tag, rtol, f64=False) -> tuple:
    """K4 against its plain version (run in float64 with ``f64``): per
    parameter array, max|diff| / max|ref| within ``rtol``. Returns the
    largest absolute and relative differences."""
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_expr import (
        expr_lowrank_vjp_cross,
    )
    from gaussianprocessfundamentals_tpu_torch.ops.expr import (
        plain_expr_lowrank_vjp_cross,
    )

    got = expr_lowrank_vjp_cross(kernel, x1, x2, U, W).double()
    torch.cuda.synchronize()
    ref32 = plain_expr_lowrank_vjp_cross(kernel, x1, x2, U, W).double()
    ref = ref32
    if f64:
        ref = plain_expr_lowrank_vjp_cross(_f64(kernel), x1.double(),
                                           x2.double(), U.double(), W.double())
    torch.cuda.synchronize()
    rels, worst_abs = [], 0.0
    for label, sl in _param_arrays(kernel):
        diff = float((got[sl] - ref[sl]).abs().max())
        rels.append((label, diff / max(float(ref[sl].abs().max()), 1e-30),
                     float((ref32[sl] - ref[sl]).abs().max())
                     / max(float(ref[sl].abs().max()), 1e-30)))
        worst_abs = max(worst_abs, diff)
    worst_rel = max(r for _, r, _ in rels)
    ok = bool(torch.isfinite(got).all()) and worst_rel <= rtol
    detail = " ".join(f"{lab} {r:.1e}" + (f" (plain {p:.1e})" if f64 else "")
                      for lab, r, p in rels)
    log(f"[k4] {tag} n1={x1.shape[0]} n2={x2.shape[0]} r={U.shape[1]} vs "
        f"plain{' f64' if f64 else ''}: {detail} (limit {rtol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    return worst_abs, worst_rel, ok


def phase_k4_check() -> tuple:
    """The expressions of phase 11 at r = 1, 17 and 273 with the JAX gate's
    zero-mean cotangent (U ~ N(0, 1)/n1, W ~ N(0, 1)) against the float32
    plain version, and at r = 273 against the float64 plain version; the
    sharp PER cases at r = 1, 17 and 273 against the float64 plain version
    only (the float32 one is not accurate there)."""
    g = torch.Generator().manual_seed(12)
    n1, n2 = 3000, 5001
    worst, failed = (0.0, 0.0), []
    for name, kernel, d in _expr_cases():
        core = _core(kernel)
        x1 = torch.rand(n1, d, generator=g).cuda()
        x2 = torch.rand(n2, d, generator=g).cuda()
        for r in (1, 17, R_MAIN):
            U = (torch.randn(n1, r, generator=g) / n1).cuda()
            W = torch.randn(n2, r, generator=g).cuda()
            a, rel, ok = _k4_check(core, x1, x2, U, W, name, K4_RTOL)
            worst = _worse(worst, (a, rel))
            failed += [] if ok else [f"{name} r={r}"]
        a, rel, ok = _k4_check(core, x1, x2, U, W, name, K4_RTOL_F64, f64=True)
        worst = _worse(worst, (a, rel))
        failed += [] if ok else [f"{name} r={R_MAIN} f64"]
    x1 = torch.rand(n1, 1, generator=g).cuda()
    x2 = torch.rand(n2, 1, generator=g).cuda()
    for name, per in _sharp_per_cases():
        for r in (1, 17, R_MAIN):
            U = (torch.randn(n1, r, generator=g) / n1).cuda()
            W = torch.randn(n2, r, generator=g).cuda()
            a, rel, ok = _k4_check(per, x1, x2, U, W, name, K4_RTOL_F64,
                                   f64=True)
            worst = _worse(worst, (a, rel))
            failed += [] if ok else [f"{name} r={r} f64"]
    if failed:
        raise RuntimeError(f"K4 disagrees with its plain version: {failed}")
    return worst


def phase_expr_oracle() -> None:
    """One streamed iterative NLL + gradient of the Mauna Loa composite at
    n = 4096 (K3 and K4 forced, 64 probes) against the float64 dense NLL
    and its gradient: NLL within 2%, the gradient vector within 15% in
    relative L2 norm (tests/test_iterative.py:88-90)."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_expr import (
        expr_gram_matvec_cross,
        expr_lowrank_vjp_cross,
    )
    from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves

    x, y, _, _ = _mauna_data(MAUNA_N_ORACLE)
    kernel = _with_params(_mauna_kernel(), MAUNA_PARAMS)
    expr_gram_matvec_cross.launches = 0
    expr_lowrank_vjp_cross.launches = 0
    nll, grad, g_noise, resid = gpt.iterative_nll_and_grad(
        kernel, x, y, NOISE, torch.Generator(device="cuda").manual_seed(0),
        num_probes=64, max_iters=100, tol=1e-4, precond_m=256,
        materialize=False)
    torch.cuda.synchronize()
    k3, k4 = expr_gram_matvec_cross.launches, expr_lowrank_vjp_cross.launches
    k64 = _f64(kernel)
    x64, y64 = x.double(), y.double()
    with k64.differentiable() as p:
        ref = chol.nll(k64.gram(x64, x64), y64, NOISE, 0.0)
        g_ref = torch.autograd.grad(ref, tree_leaves(p))
    ref = ref.detach()
    got = torch.cat([t.double().reshape(-1) for t in tree_leaves(grad)])
    want = torch.cat([t.reshape(-1) for t in g_ref])
    nll_rel = abs(float(nll) - float(ref)) / abs(float(ref))
    g_rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    ok = nll_rel <= 0.02 and g_rel <= 0.15 and k4 == 1 and k3 > 0
    log(f"[expr-oracle] Mauna composite n={MAUNA_N_ORACLE} streamed, 64 probes: "
        f"nll {float(nll):.4f} vs f64 dense {float(ref):.4f} (rel "
        f"{nll_rel:.2e}, limit 0.02); gradient rel L2 {g_rel:.2e} (limit 0.15) "
        f"over {got.numel()} parameters; max rel CG resid "
        f"{float(resid.max()):.2e}; K3 launches {k3}, K4 launches {k4} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("composite iterative NLL + gradient disagree with "
                           "the f64 dense oracle, or K4 did not run exactly once")


def _mauna_model():
    import gaussianprocessfundamentals_tpu_torch as gpt

    return gpt.GaussianProcess(_mauna_kernel(), device="cuda")


def _wrappers() -> dict:
    """The six kernels' wrappers, each with its ``launches`` count."""
    from gaussianprocessfundamentals_tpu_torch.ops import (
        cuda_dense_gram,
        cuda_expr,
        cuda_gram,
        cuda_lrvjp,
    )

    return {"K1": cuda_gram.fused_gram_matvec_cross,
            "K2": cuda_lrvjp.fused_lowrank_vjp_cross,
            "K3": cuda_expr.expr_gram_matvec_cross,
            "K4": cuda_expr.expr_lowrank_vjp_cross,
            "K5": cuda_dense_gram.se_gram,
            "K6": cuda_dense_gram.matern_gram}


def _launch_counts() -> dict:
    return {k: fn.launches for k, fn in _wrappers().items()}


def _zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def phase_expr_fit() -> dict:
    """The composite training main path: ``GaussianProcess(Mauna Loa
    composite).fit(method="auto")`` at N = 100,000 with the knobs of the SE
    fit story (10 Adam steps), every CG matvec through K3 and every gradient
    through K4."""
    from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves

    x, y, xt, truth = _mauna_data(N_MAIN, T_MAIN)
    gp = _mauna_model()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    res = gp.fit(x, y, **FIT_KWARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = [float(v) for v in res.history]
    frozen = res.diagnostics["frozen_frac"]
    fitted = [round(float(v), 6) for t in tree_leaves(res.kernel_params)
              for v in t.reshape(-1)]
    log(f"[expr-fit] N={N_MAIN} Mauna composite {gp.kernel} fit(method='auto'), "
        f"{FIT_STEPS} Adam steps: wall {wall:.3f} s, {wall / FIT_STEPS:.3f} "
        f"s/step, launches {counts}, peak mem {peak / 1e9:.3f} GB")
    log(f"[expr-fit] NLL history {[float(f'{v:.2f}') for v in hist]}; "
        f"frozen_frac {frozen}; noise {float(res.noise):.3e}; fitted "
        f"parameters (pack order) {fitted}")
    checks = {
        f"K3 launches == 25 x {FIT_STEPS}": counts["K3"] == 25 * FIT_STEPS,
        f"K4 launches == {FIT_STEPS}": counts["K4"] == FIT_STEPS,
        "no K1/K2 launch": counts["K1"] == 0 and counts["K2"] == 0,
        "NLL history finite": all(np.isfinite(hist)),
        "last NLL below first": hist[-1] < hist[0],
        "not every step frozen": frozen < 1.0,
        "peak memory <= 8 GB": peak <= 8e9,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"composite training path checks failed: {failed}")
    return {"gp": gp, "counts": counts, "x": x, "y": y, "xt": xt,
            "truth": truth}


def phase_expr_serve(fit: dict) -> dict:
    """The composite serving main path: ``.posterior`` of the fitted
    composite at 1,000 points midway between training points (the chunked
    mBCG route), every CG matvec through K3."""
    gp, xt, truth = fit["gp"], fit["xt"], fit["truth"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    post = gp.posterior(xt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    stats = post.solve_stats
    rmse = float(torch.sqrt(torch.mean((post.mean - truth) ** 2)))
    log(f"[expr-serve] N={N_MAIN} t={T_MAIN} posterior(method='auto'): wall "
        f"{wall:.3f} s, CG iters {stats['iters']}, true rel resid "
        f"{[float(f'{r:.3e}') for r in stats['rel_resid']]}, launches "
        f"{counts}, peak mem {peak / 1e9:.3f} GB, mean RMSE vs the noise-free "
        f"series {rmse:.5f} (normalised units), var range "
        f"[{float(post.var.min()):.3e}, {float(post.var.max()):.3e}]")
    checks = {
        "K3 launched, no K1": counts["K3"] > 0 and counts["K1"] == 0,
        "finite, shape": bool(torch.isfinite(post.mean).all()
                              and torch.isfinite(post.var).all())
        and tuple(post.mean.shape) == (T_MAIN,),
        "var >= 0": bool((post.var >= 0).all()),
        "true rel resid <= 1e-3 on every solve": max(stats["rel_resid"]) <= 1e-3,
        "mean RMSE <= 0.05": rmse <= 0.05,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"composite serving path checks failed: {failed}")
    return {"counts": counts}


def _special_calls(kernel, template: str) -> int:
    """Special-function calls per pair that the function needs: one exp for
    the exponential leaves under one Product together (exp(a)·exp(b) =
    exp(a + b)) and one for each other exponential leaf (SE, PER, Matérn,
    RQ), one sin per PER (and one cos for K4's period derivative), one log
    per RQ. IEEE sinf and cosf run their range reduction and polynomial on
    the multiply-add pipe, not the special-function unit: pricing each as
    one special-function call keeps the bound below their real cost."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.kernels.operators import Product

    exponential = (gpt.SquaredExponentialKernel, gpt.PeriodicKernel,
                   gpt.Matern32Kernel, gpt.Matern52Kernel,
                   gpt.RationalQuadraticKernel)

    def count(node) -> int:
        if not node.terms:
            per = type(node) is gpt.PeriodicKernel
            return (int(isinstance(node, exponential))
                    + per * (2 if template == "vjp" else 1)
                    + int(type(node) is gpt.RationalQuadraticKernel))
        if type(node) is not Product:
            return sum(count(c) for c in node.terms)
        folded = [c for c in node.terms
                  if not c.terms and isinstance(c, exponential)]
        return (sum(count(c) for c in node.terms) - len(folded)
                + min(1, len(folded)))

    return count(kernel)


def phase_expr_time(x) -> dict:
    """K3 at the fit's and the posterior's widths and K4 at the fit's rank,
    at n = 100k: each first checked against its plain version on the same
    inputs (K3 within K3_RTOL; K4 within K4_RTOL, and within K4_RTOL_F64 of
    the float64 plain version), then timed in turns with it, beside its
    bound."""
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_expr import (
        expr_gram_matvec_cross,
        expr_lowrank_vjp_cross,
    )
    from gaussianprocessfundamentals_tpu_torch.ops.expr import (
        pack_params,
        plain_expr_gram_matvec_cross,
        plain_expr_lowrank_vjp_cross,
    )

    core = _core(_with_params(_mauna_kernel(), MAUNA_PARAMS))
    pv = pack_params(core)
    g = torch.Generator().manual_seed(13)
    out = {"k3_worst": (0.0, 0.0), "k4_worst": (0.0, 0.0)}
    n_k3 = _special_calls(core, "matvec")
    for r, reps in ((1, 5), (R_CG, 5), (256, 1)):
        V = torch.randn(N_MAIN, r, generator=g).cuda()
        out["k3_worst"] = _worse(out["k3_worst"],
                                 _k3_check(core, x, x, V, "mauna"))
        ms, plain_ms = _abba_ms(
            lambda: expr_gram_matvec_cross(core, x, x, V, pv),
            lambda: plain_expr_gram_matvec_cross(core, x, x, V), reps)
        bound_ms, bound_by = _bound(N_MAIN, N_MAIN, r, 4 * N_MAIN * (2 + r),
                                    4 * N_MAIN * r, n_k3)
        log(f"[time] K3 Mauna r={r} n={N_MAIN}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, "
            f"{n_k3} special-function calls per pair): "
            f"{100 * bound_ms / ms:.1f}% of the bound")
        out[f"k3_{r}"] = (ms, plain_ms, bound_ms, bound_by)
    # chain length: every total runs over all 100k x2 rows, against float64
    V = torch.randn(N_MAIN, 256, generator=g).cuda()
    out["k3_worst"] = _worse(out["k3_worst"], _k3_check(
        core, _chain_rows(x), x, V, "mauna", f64=True))
    # zero-mean cotangent, as the fit's
    U = torch.randn(N_MAIN, R_MAIN, generator=g).cuda()
    W = torch.randn(N_MAIN, R_MAIN, generator=g).cuda()
    for f64, rtol in ((False, K4_RTOL), (True, K4_RTOL_F64)):
        a, rel, ok = _k4_check(core, x, x, U, W, "mauna", rtol, f64=f64)
        out["k4_worst"] = _worse(out["k4_worst"], (a, rel))
        if not ok:
            raise RuntimeError(f"K4 disagrees with its plain version at the "
                               f"main path's shapes (float64: {f64})")
    n_k4 = _special_calls(core, "vjp")
    Up, Wp = _as_main_path(U, W)

    def k4(U, W):
        return expr_lowrank_vjp_cross(core, x, x, U, W, pv)

    same = torch.equal(k4(U, W), k4(Up, Wp))
    log(f"[k4] mauna r={R_MAIN} padded to {Up.shape[1]} by zero columns "
        f"gives bit for bit the unpadded sums: {same}")
    if not same:
        raise RuntimeError("K4: the zero columns change the sums")
    ms, plain_ms = _abba_ms(
        lambda: k4(Up, Wp),
        lambda: plain_expr_lowrank_vjp_cross(core, x, x, Up, Wp), 1)
    ragged_ms, padded_ms = _abba_ms(lambda: k4(U, W), lambda: k4(Up, Wp), 1)
    bound_ms, bound_by = _bound(N_MAIN, N_MAIN, R_MAIN,
                                4 * 2 * N_MAIN * (1 + Up.shape[1])
                                + 4 * pv.numel(), 4 * pv.numel(), n_k4)
    log(f"[time] K4 Mauna r={R_MAIN} (+{Up.shape[1] - R_MAIN} zero columns, "
        f"as the NLL makes it) n={N_MAIN}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, {n_k4} "
        f"special-function calls per pair): {100 * bound_ms / ms:.1f}% of the "
        f"bound ({2 * N_MAIN * N_MAIN * R_MAIN / (ms * 1e-3) / 1e12:.2f} "
        f"TFLOP/s in the kernel's product); unpadded r={R_MAIN} (4-byte "
        f"copies) {ragged_ms:.3f} ms against {padded_ms:.3f} ms padded, in "
        f"turns")
    out["k4"] = (ms, plain_ms, bound_ms, bound_by)
    return out


# --- the dense exact route: K5 and K6 ----------------------------------------

N_DENSE = 16_384  # the largest power of two below the 20,000-row crossover
K56_RTOL = 2e-5  # the JAX gates se_gram_* and matern*_gram_d1
N_SEG, S_SEG = 100_000, 16
T_SEG = 10_000
N_PART = 20_000
BENCH_N = (10_000, 50_000)  # bench_pallas.py:64-69
# The dense posterior variance k_ss − ‖L⁻¹k_s‖² at N = 16,384, noise 1e-2,
# is at most ~3e-5 of k_ss = 1, and the float32 factor's rounding leaves
# ~1% of that (1.2e-2 for SE, 4.4e-3 for Matérn-5/2 on an H100): held
# relative to max|var| of the float64 posterior, with 4x room.
DENSE_VAR_RTOL = 5e-2


def _k56_check(fn, plain, x1, x2, ls, var, diag_add, tag, extra=None,
               ref=None):
    """K5 or K6 against its plain version on the same inputs (or against
    ``ref``): max|diff| / max|ref| < K56_RTOL. Returns (max|diff|, rel)."""
    extra = extra or {}
    got = fn(x1, x2, ls, var, diag_add, **extra)
    torch.cuda.synchronize()
    if ref is None:
        ref = plain(x1, x2, ls, var, diag_add, **extra)
    err = float((got.double() - ref.double()).abs().max())
    scale = float(ref.abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= K56_RTOL * scale
    log(f"[k56] {tag} n1={x1.shape[0]} n2={x2.shape[0]} d={x1.shape[1]} "
        f"diag_add={diag_add}: max|diff| {err:.3e} (limit {K56_RTOL:g} x "
        f"max|ref| {scale:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{fn.__name__} disagrees with its reference: {tag}")
    return err, err / scale


def phase_k56_check() -> dict:
    """K5 and K6 against their plain versions at ragged shapes, then the
    JAX package's four gates (``check_pallas_tpu.py:62-105``) against the
    plain version in float32 and in float64."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.ops import cuda_dense_gram as dg

    g = torch.Generator().manual_seed(18)
    worst = {"K5": (0.0, 0.0), "K6": (0.0, 0.0)}
    n1, n2 = 3000, 5001
    cases = [("K5", dg.se_gram, dg.plain_se_gram, d, {})
             for d in (1, 3, 8, 12, 40)]
    cases += [("K6", dg.matern_gram, dg.plain_matern_gram, d, {"nu": nu})
              for nu in ("32", "52") for d in (1, 2)]
    for name, fn, plain, d, extra in cases:
        x1 = torch.rand(n1, d, generator=g).cuda()
        x2 = torch.rand(n2, d, generator=g).cuda()
        ls = 0.3 * max(1.0, (d / 8) ** 0.5)  # a Gram that is not all zeros
        for a, b in ((x1, x1), (x1, x2)):
            for diag_add in (0.0, 0.25):
                worst[name] = _worse(worst[name], _k56_check(
                    fn, plain, a, b, ls, 1.3, diag_add,
                    f"{fn.__name__} {extra.get('nu', '')}".strip(), extra))
    # ARD SE through the router (x scaled by 1/ℓ), against kernel.gram
    ard = gpt.SquaredExponentialKernel(dim=3, scaled=True).set_params({
        "lengthscale": torch.tensor([0.2, 0.3, 0.4]),
        "variance": torch.tensor(1.3)}).cuda()
    x1 = torch.rand(n1, 3, generator=g).cuda()
    x2 = torch.rand(n2, 3, generator=g).cuda()
    for a, b, diag_add in ((x1, x1, 0.25), (x1, x2, 0.0)):
        before = dg.se_gram.launches
        got = dg.dense_gram_for(ard, a, b, diag_add)
        torch.cuda.synchronize()
        ref = ard.gram(a, b)
        if diag_add:
            ref = ref + diag_add * torch.eye(a.shape[0], device="cuda")
        err = float((got - ref).abs().max())
        ok = (dg.se_gram.launches == before + 1
              and err <= K56_RTOL * float(ref.abs().max()))
        log(f"[k56] ARD SE d=3 via dense_gram_for n1={a.shape[0]} "
            f"n2={b.shape[0]}: max|diff| {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("the router's ARD SE disagrees with kernel.gram")
        worst["K5"] = _worse(worst["K5"], (err, err / float(ref.abs().max())))
    # the JAX gates: n = 4096 sorted uniform, ℓ = 0.1, diag_add 0.25
    rng = np.random.default_rng(0)
    for gate, name, fn, d, var, extra in (
            ("se_gram_d1", "K5", dg.se_gram, 1, 1.3, {}),
            ("se_gram_d3", "K5", dg.se_gram, 3, 1.3, {}),
            ("matern32_gram_d1", "K6", dg.matern_gram, 1, 1.0, {"nu": "32"}),
            ("matern52_gram_d1", "K6", dg.matern_gram, 1, 1.0, {"nu": "52"})):
        x = torch.tensor(np.sort(rng.uniform(0, 1, (4096, d)), axis=0),
                         dtype=torch.float32).cuda()
        plain = dg.plain_se_gram if name == "K5" else dg.plain_matern_gram
        worst[name] = _worse(worst[name], _k56_check(
            fn, plain, x, x, 0.1, var, 0.25, f"{gate} vs float32 plain",
            extra))
        ref64 = plain(x.double(), x.double(), 0.1, var, 0.25, **extra)
        _k56_check(fn, plain, x, x, 0.1, var, 0.25, f"{gate} vs float64",
                   extra, ref=ref64)
    return worst


def _dense_kernel(kind: str, dtype=torch.float32):
    import gaussianprocessfundamentals_tpu_torch as gpt

    leaf = (gpt.SquaredExponentialKernel if kind == "se"
            else gpt.Matern52Kernel)
    return leaf(scaled=True).set_params({
        "lengthscale": torch.tensor(LENGTHSCALE, dtype=dtype),
        "variance": torch.tensor(1.0, dtype=dtype)}).cuda()


def _dense_split_ms(gp, xt) -> dict:
    """The dense posterior's three parts timed by CUDA events: the Gram
    builds (K + noise, K_s), the Cholesky, the triangular solves (y, then
    L⁻¹K_s)."""
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_dense_gram import (
        dense_gram_for,
        noised_gram,
    )

    x, y, k = gp.x_train, gp.y_train, gp.kernel
    Kn = noised_gram(k, x, gp.noise, gp.config.jitter)
    L = torch.linalg.cholesky(Kn)
    K_s = dense_gram_for(k, x, xt)

    def solves():
        z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
        torch.linalg.solve_triangular(L.mT, z, upper=True)
        torch.linalg.solve_triangular(L, K_s, upper=False)

    out = {
        "gram_ms": _time_ms(lambda: (noised_gram(k, x, gp.noise,
                                                 gp.config.jitter),
                                     dense_gram_for(k, x, xt)), 5),
        "cholesky_ms": _time_ms(lambda: torch.linalg.cholesky(Kn), 5),
        "solves_ms": _time_ms(solves, 5),
    }
    del Kn, L, K_s
    return out


def phase_dense_serve() -> dict:
    """The slice's main path: the dense posterior at N = 16,384 for SE~s
    (K5) and then Matérn-5/2~s (K6), checked against a float64 dense
    Cholesky on the card, timed, then sampled."""
    import gaussianprocessfundamentals_tpu_torch as gpt

    x, y = _data(N_DENSE, seed=19, device="cuda")
    xt = torch.linspace(0.01, 0.99, T_MAIN, device="cuda")[:, None]
    out = {"counts": {}}
    for kind, name in (("se", "K5"), ("mat52", "K6")):
        gp = gpt.GaussianProcess(_dense_kernel(kind), noise=NOISE,
                                 device="cuda").set_data(x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        post = gp.posterior(xt)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            gp.posterior(xt)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        split = _dense_split_ms(gp, xt)
        gp64 = gpt.GaussianProcess(_dense_kernel(kind, torch.float64),
                                   noise=NOISE, device="cuda").set_data(
            x.double(), y.double())
        ref = gp64.posterior(xt.double(), method="dense")
        mu_err = float((post.mean.double() - ref.mean).abs().max())
        mu_lim = 1e-3 * float(ref.mean.abs().max())
        var_err = float((post.var.double() - ref.var).abs().max())
        var_lim = DENSE_VAR_RTOL * float(ref.var.abs().max())
        del gp64, ref
        draws = gp.sample_posterior(
            xt, torch.Generator(device="cuda").manual_seed(19), 64)
        torch.cuda.synchronize()
        dev = (draws.mean(dim=0) - post.mean).abs()
        band = 4.0 * draws.std(dim=0) / 8.0
        log(f"[dense] {kind} N={N_DENSE} t={T_MAIN} posterior(method='auto'):"
            f" first {first:.4f} s, median of 5 warm "
            f"{float(np.median(walls)) * 1e3:.2f} ms (gram builds "
            f"{split['gram_ms']:.3f} ms, cholesky {split['cholesky_ms']:.3f} "
            f"ms, triangular solves {split['solves_ms']:.3f} ms), launches "
            f"{counts}, peak mem {peak / 1e9:.3f} GB; vs float64 dense: mu "
            f"max|diff| {mu_err:.3e} (limit {mu_lim:.3e}), var max|diff| "
            f"{var_err:.3e} (limit {var_lim:.3e} = {DENSE_VAR_RTOL:g} x "
            f"max|var| {var_lim / DENSE_VAR_RTOL:.3e}); 64 draws: max |mean - mu| / "
            f"(4 sd/8) {float((dev / band).max()):.3f}")
        checks = {
            f"{name} launches == 2": counts[name] == 2,
            "no other kernel": sum(counts.values()) == 2,
            "mu within 1e-3 of float64": mu_err <= mu_lim,
            f"var within {DENSE_VAR_RTOL:g} x max|var| of float64":
            var_err <= var_lim,
            "finite": bool(torch.isfinite(post.mean).all()
                           and torch.isfinite(post.var).all()),
            "draws finite, shape": bool(torch.isfinite(draws).all())
            and tuple(draws.shape) == (64, T_MAIN),
            "draw mean within 4 sd / sqrt(64)": bool((dev <= band).all()),
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise RuntimeError(f"dense serving checks failed ({kind}): {failed}")
        out["counts"][kind] = counts
        out[kind] = {"median_ms": float(np.median(walls)) * 1e3, **split}
        del gp, post, draws
    torch.cuda.empty_cache()
    return out


def _segment_function(x):
    """The segmented data's noise-free function: sin(ωₛx) + cₛ in segment
    s = ⌊16x⌋, ωₛ and cₛ varying by segment."""
    s = torch.clamp((x[:, 0] * S_SEG).floor(), 0, S_SEG - 1)
    omega = 6.0 + 2.0 * torch.remainder(s, 4)
    c = 0.3 * torch.remainder(s, 3) - 0.3
    return torch.sin(omega * x[:, 0]) + c


def _segmented_data():
    g = torch.Generator().manual_seed(20)
    x = torch.sort(torch.rand(N_SEG, 1, generator=g), dim=0).values.cuda()
    y = _segment_function(x) + 0.1 * torch.randn(N_SEG, generator=g).cuda()
    return x, y


def phase_segmented() -> dict:
    """BlockwiseGP at N = 100,000 over 16 change-point segments, SE~s and
    Matérn-5/2~s alternating: fit (dense L-BFGS per segment), predict at
    10,000 points, log marginal likelihood."""
    import gaussianprocessfundamentals_tpu_torch as gpt

    x, y = _segmented_data()
    kernels = [gpt.SquaredExponentialKernel(scaled=True) if s % 2 == 0
               else gpt.Matern52Kernel(scaled=True) for s in range(S_SEG)]
    bw = gpt.BlockwiseGP(kernels, locations=[s / S_SEG for s in range(1, S_SEG)],
                         device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    results = bw.fit(x, y, method="auto", optimize_noise=True)
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    fit_counts = _launch_counts()
    fit_peak = torch.cuda.max_memory_allocated()
    xt = torch.linspace(0.0, 1.0, T_SEG + 2, device="cuda")[1:-1, None]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    mu, _, _, var = bw.predict(xt)
    torch.cuda.synchronize()
    predict_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    lml = bw.log_marginal_likelihood()
    lml_wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rmse = float(torch.sqrt(torch.mean((mu - _segment_function(xt)) ** 2)))
    sizes = [gp.x_train.shape[0] for gp in bw.gps]
    nll_drop = [r.nll_post < r.nll_pre for r in results]
    fitted = {name: [float(r.kernel_params[name]) for r in results]
              for name in ("lengthscale", "variance")}
    fitted["noise"] = [float(r.noise) for r in results]
    log("[segmented] fitted ranges: " + ", ".join(
        f"{name} [{min(v):.4g}, {max(v):.4g}]" for name, v in fitted.items()))
    log(f"[segmented] BlockwiseGP N={N_SEG}, {S_SEG} segments of "
        f"{min(sizes)}-{max(sizes)} rows, SE~s / Matern-5/2~s: fit "
        f"{fit_wall:.3f} s (launches {fit_counts}, peak {fit_peak / 1e9:.3f} "
        f"GB, NLL fell in {sum(nll_drop)}/{S_SEG} segments), predict at "
        f"{T_SEG} points {predict_wall:.3f} s, log marginal likelihood "
        f"{lml:.2f} in {lml_wall:.3f} s; launches {counts}, peak "
        f"{peak / 1e9:.3f} GB; RMSE vs the noise-free function {rmse:.5f}")
    checks = {
        "no K5/K6 launch in the fit": fit_counts["K5"] == 0
        and fit_counts["K6"] == 0,
        "K5 == 24 and K6 == 24": counts["K5"] == 24 and counts["K6"] == 24,
        "finite": bool(torch.isfinite(mu).all() and torch.isfinite(var).all())
        and np.isfinite(lml),
        "var >= 0": bool((var >= 0).all()),
        "RMSE < 0.05": rmse < 0.05,
        "every segment's NLL fell": all(nll_drop),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"segmented path checks failed: {failed}")
    segments = [(gp.x_train, gp.y_train) for gp in bw.gps]
    del bw
    torch.cuda.empty_cache()
    return {"counts": counts, "segments": segments}


def phase_partitioned(segments) -> dict:
    """PartitionedGP over 4 boxes of d = 2 inputs (K5 at d = 2), then
    fit_segments_vmapped of SE~s over the 16 segments of phase 20."""
    import gaussianprocessfundamentals_tpu_torch as gpt

    g = torch.Generator().manual_seed(21)
    x = torch.rand(N_PART, 2, generator=g).cuda()
    truth = lambda a: torch.sin(6 * a[:, 0]) + torch.cos(4 * a[:, 1])  # noqa: E731
    y = truth(x) + 0.1 * torch.randn(N_PART, generator=g).cuda()
    pg = gpt.PartitionedGP(
        [gpt.SquaredExponentialKernel(dim=2, scaled=True) for _ in range(4)],
        model=gpt.BoxPartitioning(edges=(0.25, 0.5, 0.75), dim=0),
        device="cuda")
    t0 = time.perf_counter()
    pg.fit(x, y, method="auto", optimize_noise=True)
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    xt = torch.rand(2000, 2, generator=g).cuda()
    _zero_counts()
    t0 = time.perf_counter()
    mu = pg.predict(xt)[0]
    torch.cuda.synchronize()
    predict_wall = time.perf_counter() - t0
    counts = _launch_counts()
    rmse = float(torch.sqrt(torch.mean((mu - truth(xt)) ** 2)))
    log(f"[partitioned] PartitionedGP N={N_PART} d=2, 4 boxes, SE~s: fit "
        f"{fit_wall:.3f} s, predict at 2000 points {predict_wall:.3f} s, "
        f"launches {counts}, RMSE vs the noise-free function {rmse:.5f}")
    if counts["K5"] != 8 or not rmse < 0.05:
        raise RuntimeError("partitioned path: K5 launches != 8 or RMSE >= 0.05")
    del pg
    torch.cuda.empty_cache()

    kernel = gpt.SquaredExponentialKernel(scaled=True)
    _, _, start = gpt.fit_segments_vmapped(kernel, segments, steps=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kp, noises, final = gpt.fit_segments_vmapped(kernel, segments, steps=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"[vmapped] fit_segments_vmapped SE~s, {len(segments)} segments "
        f"padded to {max(s[0].shape[0] for s in segments)} rows, 20 Adam "
        f"steps: {wall:.3f} s ({wall / 20:.3f} s/step), peak "
        f"{peak / 1e9:.3f} GB; NLL start {[round(float(v), 1) for v in start]} "
        f"-> final {[round(float(v), 1) for v in final]}")
    if not (torch.isfinite(final).all() and (final < start).all()):
        raise RuntimeError("fit_segments_vmapped: final NLLs not finite or "
                           "not below their start")
    return {"counts": counts}


def _gram_bound(n: int, m: int, d: int):
    """(bound_ms, bound_by) of a Gram build: 4·n·m bytes out and
    4·(n + m)·d in over the memory rate, against 3·n·m·d float32
    operations and one special-function call per entry."""
    t_bytes = 4.0 * (n * m + (n + m) * d) / HBM_BYTES_PER_S
    t_ops = max(3.0 * n * m * d / F32_OPS_PER_S, n * m / EXP_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def _max_abs_diff(a, b, rows: int = 4096) -> float:
    """max|a − b| in row blocks, so a 50,000² check holds no third matrix."""
    return max(float((a[i:i + rows] - b[i:i + rows]).abs().max())
               for i in range(0, a.shape[0], rows))


def _replay_ms(graph, replays: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / replays


def _device_ms(fn, nbytes: int) -> tuple:
    """(ms, launches) of one call on the device alone: back-to-back calls
    captured in a CUDA graph, each output kept so that every launch writes
    memory of its own (≥ 4 GB over the graph, 80x the L2, up to 20
    launches: where the outputs land in memory moves a 1 GB build's time
    by ~5%), the graph replayed for ~100 ms between CUDA events. No host
    work is timed, so a wrapper that synchronised the host could not be
    captured."""
    reps = int(min(20, max(2, -(-4e9 // nbytes))))
    fn()
    torch.cuda.synchronize()
    graph, kept = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(reps):
            kept.append(fn())
    once = _replay_ms(graph, 1)
    ms = _replay_ms(graph, int(min(200, max(3, 100 / once)))) / reps
    del graph, kept
    torch.cuda.empty_cache()
    return ms, reps


def _cholesky_after(build, reps: int) -> float:
    """ms of ``torch.linalg.cholesky_ex`` of a square Gram right after its
    build, the cache state the dense route leaves it in: the best of
    ``reps``, each after a fresh build."""
    best = float("inf")
    for _ in range(reps):
        K = build()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.linalg.cholesky_ex(K)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
        del K
    return best


def phase_k56_time(dg=None, label: str = "") -> dict:
    """K5 and K6 at the JAX package's benchmark sizes (``bench_pallas.py:
    64-69``: ℓ = 0.1, var = 1.3, diag_add = 0.01 + 1e-6), at every shape
    the dense paths give them, at ragged segment sizes (m mod 4 = 1, 2, 3)
    and at d = 12 and 20 (K5, ℓ = 0.1·√(d/2)) and d = 2 (K6, both ν): each
    output held against the plain version on the same inputs (max|diff| ≤
    K56_RTOL·max|ref|), then the kernel's device time (:func:`_device_ms`)
    and the per-call wall of kernel and plain version in turns, beside the
    bound and, for a square build, the Cholesky right after it
    (:func:`_cholesky_after`). The paths' square builds carry σ² + the
    float32 effective jitter.

    ``dg`` is the ``cuda_dense_gram`` module timed (by default this
    checkout's); ``tools/dense_gram_times.py`` passes another checkout's
    with its ``label``, and then a build that checkout refuses
    (NotImplementedError) is reported and skipped."""
    from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import (
        effective_jitter_of_diag,
    )
    if dg is None:
        from gaussianprocessfundamentals_tpu_torch.ops import (
            cuda_dense_gram as dg,
        )

    rng = np.random.default_rng(22)
    bench_diag = 0.01 + 1e-6
    var = 1.3
    path_diag = NOISE + float(effective_jitter_of_diag(
        torch.full((1,), var), 1e-8))
    # SVGP's K_mm carries its jitter floor alone (phase 28)
    svgp_floor = float(effective_jitter_of_diag(torch.full((1,), var), 1e-8,
                                                2000.0))
    part_n = N_PART // 4  # one box of phase 21
    seg_n, seg_t = N_SEG // S_SEG, T_SEG // S_SEG
    # phase 20's segments hold 6,105-6,511 rows: m % 4 = 1, 2 and 3
    seg_lo, seg_hi = 6_105, 6_511
    prefix = f"[time]{f' [{label}]' if label else ''}"
    out = {"K5": {}, "K6": {}, "worst": {"K5": (0.0, 0.0), "K6": (0.0, 0.0)}}
    for n, m, d, diag, tag in (
            *((n, n, 1, bench_diag, f"{n}^2") for n in BENCH_N),
            (N_DENSE, N_DENSE, 1, path_diag, f"{N_DENSE}^2"),
            (N_DENSE, T_MAIN, 1, 0.0, f"{N_DENSE}x{T_MAIN}"),
            (seg_n, seg_n, 1, path_diag, f"{seg_n}^2"),
            (seg_n, seg_t, 1, 0.0, f"{seg_n}x{seg_t}"),
            (seg_lo, seg_lo, 1, path_diag, f"{seg_lo}^2"),
            (seg_hi, seg_hi, 1, path_diag, f"{seg_hi}^2"),
            (seg_hi, seg_hi // 10, 1, 0.0, f"{seg_hi}x{seg_hi // 10}"),
            (N_MAIN, 256, 1, 0.0, f"{N_MAIN}x256"),
            (N_NY, M_NY, 1, 0.0, f"{N_NY}x{M_NY}"),
            (M_NY, M_NY, 1, 0.0, f"{M_NY}^2"),
            (T_MAIN, M_NY, 1, 0.0, f"{T_MAIN}x{M_NY}"),
            (M_SVGP, M_SVGP, 1, svgp_floor, f"{M_SVGP}^2"),
            (M_SVGP, N_SVGP, 1, 0.0, f"{M_SVGP}x{N_SVGP}"),
            (N_PW, N_PW, 1, PW_NOISE + 1e-8, f"{N_PW}^2"),
            (N_PW, T_PW, 1, 0.0, f"{N_PW}x{T_PW}"),
            (part_n, part_n, 2, path_diag, f"{part_n}^2 d=2"),
            (part_n, 2000 // 4, 2, 0.0, f"{part_n}x{2000 // 4} d=2"),
            *((seg_n, seg_n, d, path_diag, f"{seg_n}^2 d={d}")
              for d in (12, 20))):
        x1 = torch.tensor(np.sort(rng.uniform(0, 1, (n, d)), axis=0),
                          dtype=torch.float32).cuda()
        x2 = x1 if n == m else torch.rand(m, d).cuda()
        ls = 0.1 * max(1.0, (d / 2) ** 0.5)
        reps = 2 if n * m > 1e9 else 10
        bound_ms, bound_by = _gram_bound(n, m, d)
        builds = [("K5", "", dg.se_gram, dg.plain_se_gram, {})]
        if d <= 2:
            builds.append(("K6", "", dg.matern_gram, dg.plain_matern_gram,
                           {"nu": "52"}))
        if d == 2:
            builds.append(("K6", " nu=3/2", dg.matern_gram,
                           dg.plain_matern_gram, {"nu": "32"}))
        for name, nu_tag, fn, plain, extra in builds:
            def call():
                return fn(x1, x2, ls, var, diag, **extra)

            try:
                K = call()
            except NotImplementedError as e:
                if not label:
                    raise
                log(f"{prefix} {name} {tag}{nu_tag}: refused ({e})")
                continue
            ref = plain(x1, x2, ls, var, diag, **extra)
            torch.cuda.synchronize()
            err, scale = _max_abs_diff(K, ref), float(ref.abs().max())
            ok = bool(torch.isfinite(K).all()) and err <= K56_RTOL * scale
            del K, ref
            torch.cuda.empty_cache()
            out["worst"][name] = _worse(out["worst"][name], (err, err / scale))
            if not ok:
                raise RuntimeError(f"{fn.__name__} disagrees with its plain "
                                   f"version at {tag}{nu_tag}")
            chol_ms = None
            if n == m:
                chol_ms = _cholesky_after(call, 1 if n >= 50_000 else 3)
                torch.cuda.empty_cache()
            dev_ms, graph_reps = _device_ms(call, 4 * n * m)
            call_ms, plain_ms = _abba_ms(
                call, lambda: plain(x1, x2, ls, var, diag, **extra), reps)
            torch.cuda.empty_cache()
            log(f"{prefix} {name} {tag}{nu_tag} diag_add={diag:.6g}: vs "
                f"plain max|diff| {err:.3e} (limit {K56_RTOL:g} x max|ref| "
                f"{scale:.3e}) ok; device {dev_ms:.4f} ms (graph of "
                f"{graph_reps} launches), {100 * bound_ms / dev_ms:.1f}% of "
                f"the bound {bound_ms:.4f} ms ({bound_by}); per call "
                f"{call_ms:.4f} ms; plain {plain_ms:.4f} ms; cholesky right "
                f"after a build "
                f"{'-' if chol_ms is None else f'{chol_ms:.3f} ms'}")
            out[name][tag + nu_tag] = (dev_ms, plain_ms, bound_ms, bound_by,
                                       chol_ms, call_ms)
        del x1, x2
        torch.cuda.empty_cache()
    return out


# --- covariances K1-K4 do not cover: the plain streamed versions -----------

N_CP = 20_480  # above the 20,000-row crossover: the iterative posterior
N_CP_NLL = 45_000  # above the 40,000-row cap: the streamed NLL + gradient
T_CP = 200


def _cp_kernel(dtype=torch.float32):
    """ChangePoint(SE~s, SE~s) with a sigmoid gate at 0.5, on the card:
    the routers send it to the plain streamed versions (gram_route,
    vjp_route), as the JAX package streams it."""
    import gaussianprocessfundamentals_tpu_torch as gpt

    k = gpt.ChangePoint(children=(gpt.SquaredExponentialKernel(scaled=True),
                                  gpt.SquaredExponentialKernel(scaled=True)),
                        gate=gpt.ChangePointGate("sigmoid"))
    t = lambda v: torch.tensor(v, dtype=dtype)  # noqa: E731
    k.set_params({"children": ({"lengthscale": t(0.1), "variance": t(1.0)},
                               {"lengthscale": t(0.05), "variance": t(0.5)}),
                  "locations": t([0.5])})
    return k.cuda()


def _cp_function(x):
    """sin(8x), then from 0.5 on a faster wave that starts where it ends."""
    return torch.where(x < 0.5, torch.sin(8.0 * x),
                       np.sin(4.0) + 0.5 * torch.sin(20.0 * (x - 0.5)))


def _cp_data(n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    x = torch.sort(torch.rand(n, 1, generator=g), dim=0).values
    y = _cp_function(x[:, 0]) + 0.1 * torch.randn(n, generator=g)
    return x.cuda(), y.cuda()


def phase_changepoint() -> dict:
    """A ChangePoint posterior at N = 20,480 (the chunked mBCG route, 200
    test points) against the float64 dense posterior on the card (mean
    within 1e-3 max|mean|, variance within DENSE_VAR_RTOL max|var|), with
    no K1-K4 launch; a streamed NLL +
    gradient of the same kernel at n = 4096 against the float64 dense NLL
    and its gradient (the gates of phase 7), and at n = 45,000 with no
    K2/K4 launch."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import gram_route
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_lrvjp import vjp_route
    from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves

    kernel = _cp_kernel()
    routes = (gram_route(kernel, 1), vjp_route(kernel, 1))
    x, y = _cp_data(N_CP, seed=14)
    xt = torch.linspace(0.01, 0.99, T_CP, device="cuda")[:, None]
    gp = gpt.GaussianProcess(kernel, noise=NOISE, device="cuda").set_data(x, y)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    post = gp.posterior(xt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    ref = gpt.GaussianProcess(_cp_kernel(torch.float64), noise=NOISE,
                              device="cuda").set_data(
        x.double(), y.double()).posterior(xt.double(), method="dense")
    stats = post.solve_stats
    mu_err = float((post.mean.double() - ref.mean).abs().max())
    mu_lim = 1e-3 * float(ref.mean.abs().max())
    var_err = float((post.var.double() - ref.var).abs().max())
    var_max = float(ref.var.abs().max())
    # relative to its size, as phase 19 holds the dense variance: an
    # absolute 1e-3 would pass any variance of order 1e-5
    var_lim = DENSE_VAR_RTOL * var_max
    rmse = float(torch.sqrt(torch.mean((post.mean - _cp_function(xt[:, 0])) ** 2)))
    log(f"[changepoint] N={N_CP} t={T_CP} {kernel} (routes {routes}) "
        f"posterior(method='auto'): wall {wall:.3f} s, CG iters "
        f"{stats['iters']}, true rel resid "
        f"{[float(f'{r:.3e}') for r in stats['rel_resid']]}, launches "
        f"{counts}; vs f64 dense: mu max|diff| {mu_err:.3e} (limit "
        f"{mu_lim:.3e}), var max|diff| {var_err:.3e} (limit {var_lim:.3e} "
        f"= {DENSE_VAR_RTOL:g} max|ref var|, max|ref var| {var_max:.3e}); "
        f"mean RMSE vs the noise-free function {rmse:.5f}")
    checks = {
        "routes plain": routes == ("plain", "plain"),
        "no K1-K4 launch": all(counts[k] == 0 for k in ("K1", "K2", "K3", "K4")),
        "finite, shape": bool(torch.isfinite(post.mean).all()
                              and torch.isfinite(post.var).all())
        and tuple(post.mean.shape) == (T_CP,),
        "var >= 0": bool((post.var >= 0).all()),
        "max rel CG resid <= 1e-3": max(stats["rel_resid"]) <= 1e-3,
        "mu within 1e-3 max|mu| of f64": mu_err <= mu_lim,
        "var within DENSE_VAR_RTOL max|var| of f64": var_err <= var_lim,
        "mean RMSE < 0.01": rmse < 0.01,
    }

    # the streamed NLL + gradient against the float64 dense ones, n = 4096
    xs, ys = _cp_data(4096, seed=15)
    _zero_counts()
    nll, g, _, resid = gpt.iterative_nll_and_grad(
        kernel, xs, ys, NOISE, torch.Generator(device="cuda").manual_seed(0),
        num_probes=64, max_iters=100, tol=1e-4, precond_m=256,
        materialize=False)
    torch.cuda.synchronize()
    small_counts = _launch_counts()
    k64 = _cp_kernel(torch.float64)
    with k64.differentiable() as p:
        nll64 = chol.nll(k64.gram(xs.double(), xs.double()), ys.double(),
                         NOISE, 0.0)
        g64 = torch.autograd.grad(nll64, tree_leaves(p))
    nll64 = nll64.detach()
    got = torch.cat([t.double().reshape(-1) for t in tree_leaves(g)])
    want = torch.cat([t.reshape(-1) for t in g64])
    nll_rel = abs(float(nll) - float(nll64)) / abs(float(nll64))
    g_rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    log(f"[changepoint] streamed NLL + gradient n=4096, 64 probes: nll "
        f"{float(nll):.4f} vs f64 dense {float(nll64):.4f} (rel {nll_rel:.2e}, "
        f"limit 0.02); gradient rel L2 {g_rel:.2e} (limit 0.15) over "
        f"{got.numel()} parameters; max rel CG resid {float(resid.max()):.2e}; "
        f"launches {small_counts}")
    checks["n=4096 NLL within 2% of f64 dense"] = nll_rel <= 0.02
    checks["n=4096 gradient within 15% of f64 dense"] = g_rel <= 0.15

    # above the materialisation cap: the streamed route, K never formed
    xl, yl = _cp_data(N_CP_NLL, seed=16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    nll, g, g_noise, resid = gpt.iterative_nll_and_grad(
        kernel, xl, yl, NOISE, torch.Generator(device="cuda").manual_seed(0),
        num_probes=8, max_iters=25, tol=3e-3, precond_m=256)
    torch.cuda.synchronize()
    wall_nll = time.perf_counter() - t0
    large_counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    grads = [float(v) for t in tree_leaves(g) for v in t.reshape(-1)]
    log(f"[changepoint] streamed NLL + gradient n={N_CP_NLL}: wall "
        f"{wall_nll:.3f} s, nll {float(nll):.4f}, gradient {grads}, noise "
        f"gradient {float(g_noise):.4e}, median rel CG resid "
        f"{float(resid.median()):.2e}, launches {large_counts}, peak mem "
        f"{peak / 1e9:.3f} GB")
    checks["n=4096 and n=45,000: no K1-K4 launch"] = all(
        c[k] == 0 for c in (small_counts, large_counts)
        for k in ("K1", "K2", "K3", "K4"))
    checks["n=45,000 NLL and gradient finite"] = bool(
        np.isfinite(float(nll)) and np.isfinite(grads).all()
        and np.isfinite(float(g_noise)))
    checks["n=45,000 peak memory below a float32 K"] = peak < 4 * N_CP_NLL ** 2
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"ChangePoint checks failed: {failed}")
    return {"counts": counts}


# --- the scale clauses and the approximation slice -------------------------

N_GATE, T_GATE = 50_000, 32  # check_pallas_tpu.py:413-431
N_STORY, STORY_STEPS = 200_000, 30  # VERDICT.md "Next round" #2
N_NY, M_NY, NY_STEPS = 100_000, 2_048, 20  # examples/08_approx_fit.py
# the JAX package's default ratio, m = 0.1·n: 3 steps, for the smoke's time
M_NY_RATIO, NY_STEPS_RATIO = 10_000, 3
N_SKC, M_SKC = 4_096, 128
N_SKI, M_SKI = 20_000, 2_000  # the default ratio, m = n/10


def phase_var_gate() -> dict:
    """The JAX gate ``posterior_var_50k_vs_f64_oracle``
    (``benchmarks/check_pallas_tpu.py:397-431``): the float32
    ``iterative_posterior`` at n = 50,000 on the grid i/(n−1), SE ℓ = 0.05,
    σ² = 1e-2, 32 test points, against the float64 Toeplitz/FFT oracle:
    max|var − var_oracle| < 1e-3 (k_ii = 1), the oracle's own relative
    residual < 1e-10."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.utils.toeplitz_oracle import (
        se_grid_posterior_oracle,
    )

    n, ell, nz = N_GATE, 0.05, 1e-2
    rng = np.random.default_rng(1)
    xs = rng.uniform(0.05, 0.95, T_GATE)
    g = np.arange(n) / (n - 1)
    y = np.sin(2 * np.pi * 3 * g) + 0.1 * rng.standard_normal(n)
    t0 = time.perf_counter()
    mu_t, var_t, orc_rel = se_grid_posterior_oracle(n, ell, nz, xs, y)
    orc_wall = time.perf_counter() - t0
    kernel = gpt.SquaredExponentialKernel().set_params(
        {"lengthscale": torch.tensor(ell)}).cuda()
    x = torch.tensor(g, dtype=torch.float32, device="cuda")[:, None]
    yt = torch.tensor(y, dtype=torch.float32, device="cuda")
    xt = torch.tensor(xs, dtype=torch.float32, device="cuda")[:, None]
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    mu, var = gpt.iterative_posterior(kernel, x, yt, xt, nz, max_iters=100,
                                      tol=1e-7, precond_m=256)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    var_err = float(np.max(np.abs(var.double().cpu().numpy() - var_t)))
    mu_err = float(np.max(np.abs(mu.double().cpu().numpy() - mu_t)))
    log(f"[var-gate] n={n} t={T_GATE} SE l={ell} noise={nz} float32 "
        f"iterative_posterior(max_iters=100, tol=1e-7, precond_m=256): wall "
        f"{wall:.3f} s, launches {counts}; float64 Toeplitz oracle ({orc_wall:.2f}"
        f" s, rel resid {orc_rel:.2e}, limit 1e-10): var max|diff| "
        f"{var_err:.3e} (limit 1e-3 = 1e-3 x k_ii), mu max|diff| {mu_err:.3e}, "
        f"true var range [{var_t.min():.3e}, {var_t.max():.3e}]")
    # not gated: μ's solve, on the chunked route, which reports the CG
    # iterations and true residual of every solve
    stats = {}
    mu_c, _ = gpt.iterative_posterior_chunked(kernel, x, yt, xt, nz,
                                              max_iters=100, tol=1e-7,
                                              precond_m=256, stats=stats)
    log(f"[var-gate] the same problem on the chunked route: CG iterations "
        f"{stats['iters']} (cap 100), true rel resid "
        f"{[float(f'{r:.3e}') for r in stats['rel_resid']]} (the y-solve "
        f"first), mu max|diff| "
        f"{float(np.max(np.abs(mu_c.double().cpu().numpy() - mu_t))):.3e}")
    checks = {
        "oracle rel resid < 1e-10": orc_rel < 1e-10,
        "var within 1e-3 of the oracle": var_err < 1e-3,
        "finite": bool(torch.isfinite(mu).all() and torch.isfinite(var).all()),
        "K1 launched": counts["K1"] > 0,
        "K5 launched once (K_s)": counts["K5"] == 1,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"50k variance gate failed: {failed}")
    return {"counts": counts}


def phase_story_200k() -> dict:
    """The 200k story: ``GaussianProcess(SE~s, Constant + Linear).fit(
    method="auto")`` at N = 200,000, where a float32 K would take 160 GB
    (the card has 80), 30 Adam steps with the 100k story's knobs, then
    ``.posterior`` at 1,000 points on the chunked route."""
    x, y = _trend_data(N_STORY, seed=24)
    gp = _fit_model()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    res = gp.fit(x, y, **dict(FIT_KWARGS, steps=STORY_STEPS))
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    fit_counts = _launch_counts()
    xt = torch.linspace(0.01, 0.99, T_MAIN, device="cuda")[:, None]
    t0 = time.perf_counter()
    post = gp.posterior(xt)
    torch.cuda.synchronize()
    post_wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = [float(v) for v in res.history]
    frozen = res.diagnostics["frozen_frac"]
    c = float(res.mean_params["children"][0]["c"])
    slope = float(res.mean_params["children"][1]["slope"][0])
    truth = 2.0 + 3.0 * xt[:, 0] + torch.sin(8.0 * xt[:, 0])
    rmse = float(torch.sqrt(torch.mean((post.mean - truth) ** 2)))
    stats = post.solve_stats
    chunks = -(-T_MAIN // 256)
    log(f"[story-200k] N={N_STORY} fit(method='auto'), {STORY_STEPS} Adam "
        f"steps: wall {fit_wall:.3f} s, {fit_wall / STORY_STEPS:.3f} s/step "
        f"(first step included), launches {fit_counts}; NLL history "
        f"{[float(f'{v:.2f}') for v in hist]}; skipped steps "
        f"{round(frozen * STORY_STEPS)} (frozen_frac {frozen}); noise "
        f"{float(res.noise):.5f} (data 1e-2), const {c:.4f} (2.0), slope "
        f"{slope:.4f} (3.0), lengthscale "
        f"{float(res.kernel_params['lengthscale']):.5f}, variance "
        f"{float(res.kernel_params['variance']):.5f}")
    log(f"[story-200k] posterior at {T_MAIN} points: wall {post_wall:.3f} s, "
        f"CG iters {stats['iters']}, true rel resid "
        f"{[float(f'{r:.3e}') for r in stats['rel_resid']]}, mean RMSE vs the "
        f"noise-free function {rmse:.5f}, var range "
        f"[{float(post.var.min()):.3e}, {float(post.var.max()):.3e}]; fit + "
        f"posterior launches {counts}; peak mem {peak / 1e9:.3f} GB (a "
        f"float32 K: {4 * N_STORY ** 2 / 1e9:.0f} GB)")
    checks = {
        "NLL history finite": all(np.isfinite(hist)),
        "last NLL below first": hist[-1] < hist[0],
        "no step skipped": frozen == 0.0,
        f"K2 launches == {STORY_STEPS}": fit_counts["K2"] == STORY_STEPS,
        "K1 launched": fit_counts["K1"] > 0,
        f"K5 launched once per chunk ({chunks})":
        counts["K5"] - fit_counts["K5"] == chunks,
        "max rel CG resid <= 1e-3": max(stats["rel_resid"]) <= 1e-3,
        "mean RMSE < 0.01": rmse < 0.01,
        "posterior finite, var >= 0": bool(
            torch.isfinite(post.mean).all() and torch.isfinite(post.var).all()
            and (post.var >= 0).all()),
        "peak memory < 8 GB": peak < 8e9,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"200k story checks failed: {failed}")
    return {"counts": counts}


def _se_draw(n: int, seed: int):
    """Example 08's data (``synth_se``: sorted x ~ U(0, 1), an SE draw
    with ℓ = 0.2, plus 0.1 noise) at any n: the draw is made on a
    1,024-point grid (``eigh``, as a Cholesky of the ℓ = 0.2 Gram fails)
    and linearly interpolated, which moves it by ~3e-6. Returns float32
    CUDA x [n, 1], y [n] and the noise-free f [n]."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 1.0, (n, 1)), axis=0)
    g = np.linspace(0.0, 1.0, 1024)
    w, V = np.linalg.eigh(np.exp(-0.5 * ((g[:, None] - g[None, :]) / 0.2) ** 2))
    f = np.interp(x[:, 0], g, V @ (np.sqrt(np.clip(w, 0.0, None))
                                    * rng.standard_normal(1024)))
    y = f + 0.1 * rng.standard_normal(n)
    return tuple(torch.tensor(a, dtype=torch.float32, device="cuda")
                 for a in (x, y, f))


def phase_nystroem() -> dict:
    """Example 08 at N = 100,000: ``GaussianProcess(SE~s).fit(method=
    "adam", steps=20, optimize_noise=True, approximation="nystroem",
    n_inducing=2048, optimize_inducing=True)``, then the projected-process
    ``posterior`` at 1,000 points (K5 for K_nm, K_mm and K_tm), against
    ``nystroem_posterior`` in float64 on the plain route at the fitted
    parameters, inducing set and jitter level (μ within 1e-3·max|μ|, var
    within DENSE_VAR_RTOL·max|var|); each Gram's shape held against the
    plain version; then all of it for Matérn-5/2~s (K6), and for SE~s at
    the default ratio m = 10,000 with a 3-step fit."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.fit.fit import default_inducing
    from gaussianprocessfundamentals_tpu_torch.linalg.nystroem import (
        nystroem_jitter,
        nystroem_posterior,
    )
    from gaussianprocessfundamentals_tpu_torch.ops import cuda_dense_gram as dg

    x, y, f = _se_draw(N_NY, seed=26)
    xt = torch.linspace(0.01, 0.99, T_MAIN, device="cuda")[:, None]
    out = {"counts": {}, "worst": {"K5": (0.0, 0.0), "K6": (0.0, 0.0)}}
    se = ("se", "K5", gpt.SquaredExponentialKernel, dg.se_gram,
          dg.plain_se_gram, {})
    mat52 = ("mat52", "K6", gpt.Matern52Kernel, dg.matern_gram,
             dg.plain_matern_gram, {"nu": "52"})
    for (kind, name, leaf, fn, plain, extra), m, steps in (
            (se, M_NY, NY_STEPS), (mat52, M_NY, NY_STEPS),
            (se, M_NY_RATIO, NY_STEPS_RATIO)):
        if m != M_NY:
            kind = f"{kind}_m{m}"
        gp = gpt.GaussianProcess(leaf(scaled=True), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        res = gp.fit(x, y, method="adam", steps=steps, optimize_noise=True,
                     approximation="nystroem", n_inducing=m,
                     optimize_inducing=True)
        torch.cuda.synchronize()
        fit_wall = time.perf_counter() - t0
        fit_counts = _launch_counts()
        fit_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        post = gp.posterior(xt)
        torch.cuda.synchronize()
        post_wall = time.perf_counter() - t0
        counts = _launch_counts()
        post_peak = torch.cuda.max_memory_allocated()
        z = gp.inducing
        with torch.no_grad():
            jit = float(nystroem_jitter(dg.dense_gram_for(gp.kernel, z, z),
                                        gp.config.jitter))
        k64 = _f64(gp.kernel)
        args = (k64, x.double(), y.double(), z.double(), xt.double(),
                gp.noise.double())
        ref_mu, ref_var = nystroem_posterior(*args, jit)
        cfg_mu, cfg_var = nystroem_posterior(*args, gp.config.jitter)
        mu_err = float((post.mean.double() - ref_mu).abs().max())
        mu_lim = 1e-3 * float(ref_mu.abs().max())
        var_err = float((post.var.double() - ref_var).abs().max())
        var_max = float(ref_var.abs().max())
        var_lim = DENSE_VAR_RTOL * var_max
        cfg_mu_rel = float((post.mean.double() - cfg_mu).abs().max()
                           / cfg_mu.abs().max())
        cfg_var_rel = float((post.var.double() - cfg_var).abs().max()
                            / cfg_var.abs().max())
        rmse = float(torch.sqrt(torch.mean(
            (post.mean - torch.tensor(np.interp(
                xt[:, 0].cpu().numpy(), x[:, 0].cpu().numpy(),
                f.cpu().numpy()), dtype=torch.float32, device="cuda")) ** 2)))
        hist = [float(v) for v in res.history]
        params = {k: round(float(v), 6) for k, v in res.kernel_params.items()}
        moved = float((z - default_inducing(x, m)).abs().max())
        log(f"[nystroem] {kind} N={N_NY} m={m} fit(method='adam', "
            f"{steps} steps, optimize_inducing): wall {fit_wall:.3f} s, "
            f"{fit_wall / steps:.3f} s/step (first step included), "
            f"launches {fit_counts}, peak mem {fit_peak / 1e9:.3f} GB; NLL "
            f"history {[float(f'{v:.1f}') for v in hist]}; fitted {params}, "
            f"noise {float(res.noise):.4e}; inducing inputs moved by up to "
            f"{moved:.4f}")
        log(f"[nystroem] {kind} projected-process posterior at {T_MAIN} points: "
            f"wall {post_wall:.4f} s, launches {counts}, peak mem "
            f"{post_peak / 1e9:.3f} GB, mean RMSE vs the noise-free draw "
            f"{rmse:.5f}; vs float64 nystroem_posterior at the jitter level "
            f"the float32 K_mm needed ({jit:.3e}): mu max|diff| {mu_err:.3e} "
            f"(limit {mu_lim:.3e}), var max|diff| {var_err:.3e} (limit "
            f"{var_lim:.3e} = {DENSE_VAR_RTOL:g} x max|var| {var_max:.3e}); "
            f"at the config jitter ({gp.config.jitter:g}, a different "
            f"regularisation): mu {cfg_mu_rel:.2e}, var {cfg_var_rel:.2e} "
            f"of max")
        ls = float(gp.kernel.lengthscale)
        var_k = float(gp.kernel.variance)
        for a, b, tag in ((x, z, "K_nm"), (z, z, "K_mm"), (xt, z, "K_tm")):
            out["worst"][name] = _worse(out["worst"][name], _k56_check(
                fn, plain, a, b, ls, var_k, 0.0, f"nystroem {kind} {tag}",
                extra))
        checks = {
            "the fit (kernel.gram under autograd) launches no kernel":
            sum(fit_counts.values()) == 0,
            "fit NLL history finite": all(np.isfinite(hist)),
            "fit: last NLL below first": hist[-1] < hist[0],
            "inducing set finite": bool(torch.isfinite(z).all()),
            f"{name} launched once per Gram (3)": counts[name] == 3,
            "no other kernel": sum(counts.values()) == 3,
            "mu within 1e-3 of float64": mu_err <= mu_lim,
            f"var within {DENSE_VAR_RTOL:g} x max|var| of float64":
            var_err <= var_lim,
            "finite, var >= 0": bool(torch.isfinite(post.mean).all()
                                     and torch.isfinite(post.var).all()
                                     and (post.var >= 0).all()),
        }
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise RuntimeError(f"Nystroem checks failed ({kind}): {failed}")
        out["counts"][kind] = counts
        del gp, post, res, k64, args, ref_mu, ref_var, cfg_mu, cfg_var
        torch.cuda.empty_cache()
    return out


def phase_skc_ski() -> None:
    """The SKC bounds and the Nyström log likelihood at n = 4,096 (value
    and gradient with respect to ℓ, σ², the noise and the inducing inputs):
    skc_lower ≤ the float64 dense log likelihood ≤ skc_upper
    (``tests/test_block_cholesky.py:78-102``), gradients finite; then SKI's
    ``ski_mll`` and ``ski_mll_toeplitz`` at N = 20,000 on m = 2,000 grid
    points, value and gradient finite, with their CG iteration counts (the
    absolute test max|r| < 1e-6, capped at 4n)."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.fit.fit import default_inducing
    from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
    from gaussianprocessfundamentals_tpu_torch.linalg.nystroem import (
        nystroem_mll,
    )
    from gaussianprocessfundamentals_tpu_torch.linalg.ski import (
        ski_mll,
        ski_mll_toeplitz,
    )
    from gaussianprocessfundamentals_tpu_torch.objectives.skc import (
        skc_lower_bound,
        skc_upper_bound,
    )

    def kernel(dtype=torch.float32):
        return gpt.SquaredExponentialKernel(scaled=True).set_params({
            "lengthscale": torch.tensor(0.2, dtype=dtype),
            "variance": torch.tensor(1.0, dtype=dtype)}).cuda()

    x, y, _ = _se_draw(N_SKC, seed=27)
    k64 = kernel(torch.float64)
    exact = float(chol.mll(k64.gram(x.double(), x.double()), y.double(),
                           NOISE, 1e-8))
    z0 = default_inducing(x, M_SKC)
    vals, grads = {}, {}
    for label, fn in (("skc_lower", skc_lower_bound),
                      ("skc_upper", skc_upper_bound),
                      ("nystroem", nystroem_mll)):
        k = kernel()
        z = z0.clone().requires_grad_(True)
        noise = torch.tensor(NOISE, device="cuda", requires_grad=True)
        with k.differentiable() as p:
            v = fn(k, x, y, z, noise, 1e-8)
            g = torch.autograd.grad(v, [p["lengthscale"], p["variance"],
                                        noise, z])
        vals[label] = float(v.detach())
        grads[label] = [float(t.abs().max()) for t in g]
    finite = all(np.isfinite(vals[k]) and np.isfinite(grads[k]).all()
                 for k in vals)
    ok = vals["skc_lower"] <= exact <= vals["skc_upper"] and finite
    log(f"[skc] n={N_SKC} m={M_SKC} SE~s l=0.2 noise={NOISE} float32: "
        f"skc_lower {vals['skc_lower']:.3f} <= float64 dense mll {exact:.3f} "
        f"<= skc_upper {vals['skc_upper']:.3f}; nystroem mll "
        f"{vals['nystroem']:.3f}; max|gradient| (l, var, noise, z) {grads}; "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("SKC sandwich or gradients failed")

    x, y, _ = _se_draw(N_SKI, seed=28)
    grid = default_inducing(x, M_SKI, "ski")
    for fn in (ski_mll, ski_mll_toeplitz):
        k = kernel()
        noise = torch.tensor(NOISE, device="cuda", requires_grad=True)
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with k.differentiable() as p:
            v = fn(k, x, y, grid, noise, 1e-8, stats=stats)
            g = torch.autograd.grad(v, [p["lengthscale"], p["variance"],
                                        noise])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gv = [float(t) for t in g]
        ok = bool(torch.isfinite(v).all()) and np.isfinite(gv).all()
        log(f"[ski] {fn.__name__} N={N_SKI} m={M_SKI} float32: value "
            f"{float(v.detach()):.3f}, gradient (l, var, noise) "
            f"{[float(f'{t:.4e}') for t in gv]}, CG iterations (forward, "
            f"backward) {stats['iters']} (cap {4 * N_SKI}), wall {wall:.3f} s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"{fn.__name__}: value or gradient not finite")


# --- SVGP, pathwise sampling, the kernel search, batched fit -----------------

# BASELINE config 4 and examples/04_svgp_100k.py: N = 100k, m = 512
N_SVGP, M_SVGP, B_SVGP, SVGP_STEPS = 100_000, 512, 4_096, 3_000
SVGP_MSE_ROWS = 20_000
# example 06 at the dense route's top: N = 20,000 rows (the posterior's
# dense-to-chunked crossover), t = 1,000, 64 paths of 2,048 features
N_PW, T_PW, S_PW, D_PW, PW_ITERS = 20_000, 1_000, 64, 2_048, 300
PW_NOISE = 1e-2
# the variance gate's band on (sample variance / posterior variance): the
# chi-square spread of 64 paths (chi2_63/63 in [0.40, 1.86] at 1e-5 per
# point) times the RFF variance bias at D = 2,048 (0.74-1.01 pointwise with
# 1,024 paths at N = 3,000 and 8,000 on the CPU); the mean of the ratio
# over the test points is held to [0.6, 1.4]
PW_VAR_BAND, PW_VAR_MEAN_BAND = (0.3, 2.5), (0.6, 1.4)
# examples/10_kernel_search_mauna.py's knobs
SEARCH_DEPTH, SEARCH_RESTARTS, SEARCH_STEPS = 2, 2, 150
B_BATCH, N_BATCH = 8, 4_000
BATCH_RTOL = 1e-3


def svgp_data(n: int, seed: int = 0):
    """examples/04_svgp_large.py's data, drawn as it draws them (numpy's
    ``default_rng(seed)``): x ~ U(0, 1), y = sin(12x) + 0.5·sin(31x) +
    0.1ε, float32 on the card."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 1))
    y = (np.sin(12 * x[:, 0]) + 0.5 * np.sin(31 * x[:, 0])
         + 0.1 * rng.standard_normal(n))
    return (torch.tensor(x, dtype=torch.float32, device="cuda"),
            torch.tensor(y, dtype=torch.float32, device="cuda"))


def svgp_transient_steps(hist) -> int:
    """Steps after the first 1,000 whose −ELBO lies more than 2e4 above
    the median of those steps: the fit's transients (inducing inputs that
    cross leave the whitened basis steep, ROADMAP.md §3 item 4)."""
    late = np.asarray(hist)[1000:]
    return int((late > np.median(late) + 2e4).sum())


def phase_svgp() -> dict:
    """BASELINE config 4 on example 04's data (:func:`svgp_data`):
    ``fit_svgp`` of SE~s at N = 100,000, m = 512, batch 4,096, lr 1e-2,
    3,000 Adam steps in float32 (steps/s, −ELBO first and last, NaNs and
    transient steps in the history, peak memory), then ``svgp_predict`` at
    the 100,000 training inputs: exactly 2 K5 launches (K_mm + its jitter
    floor, K_mx), none of K1-K4; MSE on the first 20,000 rows < 0.02 (the
    noise floor is 0.01); var ≥ 0; μ within 1e-3·max|μ| and var within
    DENSE_VAR_RTOL·max|var| of ``svgp_predict`` in float64 on the card at
    the same parameters and K_mm jitter (the float32 floor, 2000·eps·mean
    diag, is part of the model); K5 held against its plain version at
    512² and 512 × 100,000; then 5 more steps under
    ``torch.cuda.set_sync_debug_mode("error")``: no step reads the host."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import (
        effective_jitter_of_diag,
    )
    from gaussianprocessfundamentals_tpu_torch.models import svgp
    from gaussianprocessfundamentals_tpu_torch.ops import cuda_dense_gram as dg
    from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_map

    x, y = svgp_data(N_SVGP)
    kernel = gpt.SquaredExponentialKernel(scaled=True).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    params, hist = gpt.fit_svgp(kernel, x, y, m=M_SVGP, generator=gen,
                                batch_size=B_SVGP, steps=SVGP_STEPS, lr=1e-2)
    torch.cuda.synchronize()
    fit_wall = time.perf_counter() - t0
    fit_counts = _launch_counts()
    fit_peak = torch.cuda.max_memory_allocated()
    h = hist.cpu().numpy()  # the history's one read to the host
    nans = int(np.isnan(h).sum())
    transients = svgp_transient_steps(h)

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    mu, var = gpt.svgp_predict(kernel, params, x)
    torch.cuda.synchronize()
    pred_wall = time.perf_counter() - t0
    counts = _launch_counts()
    pred_peak = torch.cuda.max_memory_allocated()
    rows = slice(0, SVGP_MSE_ROWS)
    mse = float(torch.mean((mu[rows] - y[rows]) ** 2))

    floor = float(effective_jitter_of_diag(kernel.diag(params.z), 1e-8,
                                           2000.0))
    p64 = svgp.SVGPParams(tree_map(torch.Tensor.double, params.kernel_u),
                          *(t.double() for t in params[1:]))
    mu64, var64 = gpt.svgp_predict(_f64(kernel), p64, x.double(),
                                   jitter=floor)
    mu_err = float((mu.double() - mu64).abs().max())
    mu_lim = 1e-3 * float(mu64.abs().max())
    var_err = float((var.double() - var64).abs().max())
    var_max = float(var64.abs().max())
    var_lim = DENSE_VAR_RTOL * var_max
    ls, vk = float(kernel.lengthscale), float(kernel.variance)
    worst = _worse(
        _k56_check(dg.se_gram, dg.plain_se_gram, params.z, params.z, ls, vk,
                   floor, "svgp K_mm + floor"),
        _k56_check(dg.se_gram, dg.plain_se_gram, params.z, x, ls, vk, 0.0,
                   "svgp K_mx"))

    trained, opt = svgp.svgp_adam_init(params, 1e-2)

    def step():
        idx = torch.randint(0, N_SVGP, (B_SVGP,), generator=gen,
                            device="cuda")
        return svgp.svgp_adam_step(kernel, trained, opt, x[idx], y[idx],
                                   N_SVGP)

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sync_losses = torch.stack([step() for _ in range(5)])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"[svgp] N={N_SVGP} SE~s m={M_SVGP} batch={B_SVGP} lr=1e-2 float32: "
        f"{SVGP_STEPS} Adam steps in {fit_wall:.3f} s ("
        f"{SVGP_STEPS / fit_wall:.1f} steps/s, initialisation included), "
        f"-ELBO {h[0]:.1f} -> {h[-1]:.1f}, NaNs in the history {nans}, "
        f"transient steps after step 1000 {transients}, "
        f"launches {fit_counts}, peak mem {fit_peak / 1e9:.3f} GB; fitted "
        f"l={ls:.5f} var={vk:.5f} noise={float(params.log_noise.exp()):.5f}")
    log(f"[svgp] svgp_predict at {N_SVGP} points: wall {pred_wall:.4f} s, "
        f"launches {counts}, peak mem {pred_peak / 1e9:.3f} GB; MSE on the "
        f"first {SVGP_MSE_ROWS} rows {mse:.5f} (limit 0.02; noise 0.01); vs "
        f"float64 on the card at the K_mm jitter {floor:.3e}: mu max|diff| "
        f"{mu_err:.3e} (limit {mu_lim:.3e}), var max|diff| {var_err:.3e} "
        f"(limit {var_lim:.3e} = {DENSE_VAR_RTOL:g} x max|var| {var_max:.3e}); "
        f"5 steps under sync debug mode 'error': no host read, losses "
        f"{[float(f'{v:.1f}') for v in sync_losses.cpu()]}")
    checks = {
        "no NaN in the history": nans == 0,
        "-ELBO falls": h[-1] < h[0],
        "the fit (kernel.gram under autograd) launches no kernel":
        sum(fit_counts.values()) == 0,
        "2 K5 launches per predict": counts["K5"] == 2,
        "no other kernel": sum(counts.values()) == 2,
        "MSE on the first 20,000 rows < 0.02": mse < 0.02,
        "finite, var >= 0": bool(torch.isfinite(mu).all()
                                 and torch.isfinite(var).all()
                                 and (var >= 0).all()),
        "mu within 1e-3 of float64": mu_err <= mu_lim,
        f"var within {DENSE_VAR_RTOL:g} x max|var| of float64":
        var_err <= var_lim,
        "sync-debug steps finite": bool(torch.isfinite(sync_losses).all()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"SVGP checks failed: {failed}")
    return {"counts": counts, "worst": worst}


def _pathwise_problem():
    """Example 06 at N = 20,000: ``synth_se``'s recipe (``_se_draw``:
    ℓ = 0.2, noise sd 0.1), t = 1,000 grid points, Matérn-5/2~s at ℓ = 0.2,
    variance 1; and the facade's dense posterior in float64 on the card at
    the same parameters. Returns (kernel, x, y, xt, μ, var)."""
    import gaussianprocessfundamentals_tpu_torch as gpt

    x, y, _ = _se_draw(N_PW, seed=29)
    xt = torch.linspace(0.0, 1.0, T_PW, device="cuda")[:, None]
    kernel = gpt.Matern52Kernel(scaled=True).set_params({
        "lengthscale": torch.tensor(0.2), "variance": torch.tensor(1.0)}).cuda()
    gp64 = gpt.GaussianProcess(_f64(kernel), noise=PW_NOISE,
                               device="cuda").set_data(x.double(), y.double())
    post = gp64.posterior(xt.double(), method="dense")
    torch.cuda.synchronize()
    return kernel, x, y, xt, post.mean, post.var


def pathwise_gates(samples, mu, var) -> dict:
    """Phase 29's gates on draws [s, t] against the float64 posterior:
    the sample mean within 4·sd/√s + 1e-3·max|μ| of μ at every point (the
    RFF prior draws and the noise draws have mean zero for any feature
    set, so the mean carries no RFF bias; 1e-3·max|μ| covers float32 and
    the CG), and the sample variance / var inside PW_VAR_BAND at every
    point and PW_VAR_MEAN_BAND on average. Returns the readings, with
    ``ok``."""
    s = samples.shape[0]
    sd = torch.sqrt(var)
    m, v = samples.double().mean(0), samples.double().var(0)
    mean_lim = 4.0 * sd / s ** 0.5 + 1e-3 * float(mu.abs().max())
    ratio = v / var
    out = {"mean_excess": float(((m - mu).abs() / mean_lim).max()),
           "mean_z": float(((m - mu).abs() / (sd / s ** 0.5)).max()),
           "ratio_min": float(ratio.min()), "ratio_max": float(ratio.max()),
           "ratio_mean": float(ratio.mean())}
    out["ok"] = (out["mean_excess"] <= 1.0
                 and PW_VAR_BAND[0] <= out["ratio_min"]
                 and out["ratio_max"] <= PW_VAR_BAND[1]
                 and PW_VAR_MEAN_BAND[0] <= out["ratio_mean"]
                 <= PW_VAR_MEAN_BAND[1])
    return out


def phase_pathwise() -> dict:
    """Example 06 at the dense route's top: ``pathwise_posterior_samples``
    of Matérn-5/2~s at N = 20,000, 64 paths at 1,000 points, D = 2,048
    features, 300 CG iterations: exactly 2 K6 launches (K + (σ² +
    jitter)·I, K_s) and none of K1-K4; :func:`pathwise_gates` against the
    facade's float64 dense posterior; K6 held against its plain version at
    both shapes."""
    from gaussianprocessfundamentals_tpu_torch.models.rff import (
        pathwise_posterior_samples,
    )
    from gaussianprocessfundamentals_tpu_torch.ops import cuda_dense_gram as dg

    kernel, x, y, xt, mu, var = _pathwise_problem()
    gen = torch.Generator(device="cuda").manual_seed(29)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    samples = pathwise_posterior_samples(
        kernel, x, y, xt, PW_NOISE, gen, num_samples=S_PW,
        num_features=D_PW, max_iters=PW_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gates = pathwise_gates(samples, mu, var)
    shift = PW_NOISE + 1e-8
    worst = _worse(
        _k56_check(dg.matern_gram, dg.plain_matern_gram, x, x, 0.2, 1.0,
                   shift, "pathwise K + (noise + jitter)I", {"nu": "52"}),
        _k56_check(dg.matern_gram, dg.plain_matern_gram, x, xt, 0.2, 1.0,
                   0.0, "pathwise K_s", {"nu": "52"}))
    log(f"[pathwise] N={N_PW} Matern-5/2~s l=0.2 noise={PW_NOISE} "
        f"{S_PW} paths at {T_PW} points, D={D_PW}, {PW_ITERS} CG iterations: "
        f"wall {wall:.3f} s, launches {counts}, peak mem {peak / 1e9:.3f} GB; "
        f"vs the float64 dense posterior (var {float(var.min()):.3e}-"
        f"{float(var.max()):.3e}): max|mean - mu| / (sd/8) "
        f"{gates['mean_z']:.3f}, / its limit {gates['mean_excess']:.3f} "
        f"(<= 1); sample var / var min {gates['ratio_min']:.3f} max "
        f"{gates['ratio_max']:.3f} (band {PW_VAR_BAND}) mean "
        f"{gates['ratio_mean']:.3f} (band {PW_VAR_MEAN_BAND}) "
        f"{'ok' if gates['ok'] else 'FAIL'}")
    checks = {
        "2 K6 launches": counts["K6"] == 2,
        "no other kernel": sum(counts.values()) == 2,
        "samples finite": bool(torch.isfinite(samples).all()),
        "mean and variance gates": gates["ok"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"pathwise checks failed: {failed}")
    return {"counts": counts, "worst": worst}


def _mauna_csv():
    """``data/d2_mauna_loa.csv`` through the port's loader (x and y min-max
    normalised over every row, no shuffle), the first 80% for training and
    the rest held out, float64 on the card."""
    import gaussianprocessfundamentals_tpu_torch as gpt

    di = gpt.load_named("mauna_loa", test_ratio=0.0, dtype=torch.float64,
                        device="cuda")
    cut = int(0.8 * di.n_train)
    x, y = di.x_train, di.y_train
    return x[:cut], y[:cut], x[cut:], y[cut:]


def phase_search() -> dict:
    """Example 10: ``greedy_kernel_search`` on the Mauna Loa record
    (max_depth=2, restarts=2, steps=150) in float64 on the card (the
    dense route at n = 420; K5/K6 take float32 only), then the found
    structure's posterior through the facade on the held-out 20%: BIC
    trace, structure, candidates, wall, held-out MSE; the score ≤ the best
    base kernel's, every candidate's BIC finite, no kernel launched."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.models.search import (
        default_base_kernels,
    )

    x, y, xh, yh = _mauna_csv()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gpt.greedy_kernel_search(
        x, y, max_depth=SEARCH_DEPTH, seed=0,
        fit_kwargs={"steps": SEARCH_STEPS, "restarts": SEARCH_RESTARTS,
                    "optimize_noise": True})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gp = gpt.GaussianProcess(res.kernel, noise=res.noise,
                             device="cuda").set_data(x, y)
    post = gp.posterior(xh)
    counts = _launch_counts()
    mse = float(torch.mean((post.mean - yh) ** 2))
    base_best = min(s for _, s in res.history[:len(default_base_kernels())])
    log(f"[search] Mauna Loa n_train={x.shape[0]} n_held_out={xh.shape[0]} "
        f"float64, max_depth={SEARCH_DEPTH} restarts={SEARCH_RESTARTS} "
        f"steps={SEARCH_STEPS}: BIC trace "
        f"{[(name, round(s, 1)) for name, s in res.history]}")
    log(f"[search] found {res.kernel} (canonical {res.kernel.canonical_str()})"
        f", BIC {res.score:.1f} (best base {base_best:.1f}); "
        f"{len(res.history)} candidates in {wall:.1f} s; held-out MSE "
        f"{mse:.6f} (normalised y); launches {counts}; the JAX package's "
        "run found MAT52*PER + MAT52")
    checks = {
        "score <= the best base kernel's": res.score <= base_best,
        "every candidate's BIC finite":
        all(np.isfinite(s) for _, s in res.history),
        "held-out MSE finite": np.isfinite(mse),
        "no kernel launched": sum(counts.values()) == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"kernel search checks failed: {failed}")
    return {"counts": counts}


def phase_batched_fit() -> dict:
    """8 copies of one 4,000-row problem (the SE training data of phase 8,
    SE~s + Constant + Linear) through ``fit(method="auto")`` as one batched
    [8, 4000, 1] input (the dense L-BFGS route, one parameter set), against
    ``fit`` on the one problem: parameters and NLL within 1e-3 relative;
    wall time and peak memory of both. In float64: the gate holds the
    batched objective to the single one, and in float32 the two L-BFGS
    runs part within the optimum's flat directions (8e-4 relative at
    3 x 600 rows on the CPU), which says nothing about the batching."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves

    x, y = (t.double() for t in _trend_data(N_BATCH, seed=31))
    runs = {}
    for tag, xx, yy in (("one", x, y),
                        ("batched", x.expand(B_BATCH, -1, -1),
                         y.expand(B_BATCH, -1))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        res = gpt.fit(gpt.SquaredExponentialKernel(scaled=True).cuda(), xx, yy,
                      mean=(gpt.ConstantMean() + gpt.LinearMean(dim=1)).cuda(),
                      method="auto", optimize_noise=True, noise=1e-2)
        torch.cuda.synchronize()
        runs[tag] = (res, time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated(), _launch_counts())
    vals = {tag: np.array([float(t) for t in
                           tree_leaves(r[0].kernel_params)
                           + tree_leaves(r[0].mean_params)]
                          + [float(r[0].noise), r[0].nll_post])
            for tag, r in runs.items()}
    rel = float(np.max(np.abs(vals["batched"] - vals["one"])
                       / np.abs(vals["one"])))
    counts = runs["batched"][3]
    log(f"[batched-fit] {B_BATCH} x {N_BATCH} rows, SE~s + Constant + Linear, "
        f"float64, fit(method='auto') (dense L-BFGS): batched wall "
        f"{runs['batched'][1]:.3f} s, peak mem {runs['batched'][2] / 1e9:.3f} "
        f"GB; one problem wall {runs['one'][1]:.3f} s, peak mem "
        f"{runs['one'][2] / 1e9:.3f} GB; (l, var, const, slope, noise, NLL) "
        f"batched {np.round(vals['batched'], 6).tolist()} one "
        f"{np.round(vals['one'], 6).tolist()}: max relative diff {rel:.3e} "
        f"(limit {BATCH_RTOL:g}); launches {counts}")
    checks = {
        "8 copies fit the one problem's parameters and NLL": rel <= BATCH_RTOL,
        "NLL falls": runs["batched"][0].nll_post < runs["batched"][0].nll_pre,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"batched fit checks failed: {failed}")
    return {"counts": counts}


# --- BASELINE config 3 (phase 32) and M11 on the card (phase 33) -----------

# benchmarks/run_all.py:164-260 (bench_nuts): n = 1,000, 8 chains from the
# defaults + 0.1·N(0, 1), 300 warmup transitions and 300 draws at
# max_depth 6, then resumed segments of 300. Cut for the time limit: 2
# resumed segments, not r4's 4 (900 draws a chain, not 1,500), and
# hmc_chains' 600 draws to 300 (uncut, the phase took 725 s on the card
# before the stacked Gram was vmapped; cut, it takes ~330 s; PERF.md §5)
N_NUTS, C_NUTS, NUTS_DEPTH = 1_000, 8, 6
NUTS_WARMUP, NUTS_SEG, NUTS_RESUMED = 300, 300, 2
NUTS_PRIOR_VAR = 9.0  # the N(0, 3²) prior on the unconstrained leaves
# HMC's draws cut 300 → 100 when phases 34-36 joined the smoke (its time
# limit); the gates are unchanged
HMC_WARMUP, HMC_DRAWS, HMC_LEAPFROG = 300, 100, 16
NUTS_DIV_MAX, NUTS_ACCEPT = 0.05, (0.6, 0.95)
NUTS_RHAT_MAX, NUTS_ESS_MIN, NUTS_MAX_LAG = 1.1, 100.0, 200
NUTS_NOISE_BAND = (0.007, 0.014)  # posterior mean of σ² (truth 0.01)
NUTS_PARAMS = ("log lengthscale", "log variance", "log noise")  # ravel order
# what torch.cuda.set_sync_debug_mode("warn") says at each synchronisation
SYNC_WARNING = "called a synchronizing CUDA operation"
# phase 33: the metric factory at n = 4,096 (σ² 0.1, SE~s ℓ 0.2), float32
# against float64 on the card: the dense Cholesky LL (by Cholesky or CG)
# and BIC carry the float32 factor's rounding, the O(nm²) families their
# float32 Grams only (the algebra is float64)
N_M11, M11_NOISE = 4_096, 0.1
M11_RTOL = {"ll": 3e-3, "ll_cg": 3e-3, "bic": 3e-3, "nystroem": 3e-4,
            "skc_lower": 3e-4, "skc_upper": 3e-4, "ski": 3e-4, "mse": 3e-4}


def _nuts_data(device="cuda", dtype=torch.float64):
    """Config 3's data: ``synth_se(n=1000, 0.2, 0.1, seed=0)``."""
    from gaussianprocessfundamentals_tpu_torch.data.datasets import synth_se

    x, y = synth_se(n=N_NUTS, lengthscale=0.2, noise_sd=0.1, seed=0)
    return (torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(y, dtype=dtype, device=device))


def _nuts_target(device="cuda", dtype=torch.float64):
    """Config 3's log posterior over a stacked tree of C chains (the dense
    Matérn-5/2~s NLL of ``synth_se(n=1000, 0.2, 0.1, seed=0)`` with the
    noise, through ``make_stacked_nll``, and the N(0, 3²) prior on every
    unconstrained leaf) and the default start, on ``device``."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.fit.fit import init_uparams
    from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves

    x, y = _nuts_data(device, dtype)
    kern = gpt.Matern52Kernel(scaled=True).to(device)
    nll = gpt.make_stacked_nll(kern, gpt.ZeroMean(), x, y,
                               optimize_noise=True)

    def logprob(u):
        leaves = tree_leaves(u)
        C = leaves[0].shape[0]
        return -nll(u) - 0.5 * sum((l ** 2).reshape(C, -1).sum(-1)
                                   for l in leaves) / NUTS_PRIOR_VAR

    u0 = init_uparams(kern, gpt.ZeroMean(), [[0.0, 1.0]], N_NUTS,
                      dtype=dtype, optimize_noise=True, device=device)
    return logprob, u0


def _chain_stats(flat) -> dict:
    """Per parameter of flat draws [C, S, 3]: pooled mean and sd, split-R̂,
    ESS (max_lag 200, as run_all.py) and se = sd/√ESS."""
    import gaussianprocessfundamentals_tpu_torch as gpt

    out = {}
    for i, name in enumerate(NUTS_PARAMS):
        t = flat[..., i].double().cpu()
        ess = float(gpt.effective_sample_size(t, max_lag=NUTS_MAX_LAG))
        sd = float(t.std())
        out[name] = {"mean": float(t.mean()), "sd": sd, "ess": ess,
                     "rhat": float(gpt.potential_scale_reduction(t)),
                     "se": sd / np.sqrt(ess)}
    return out


def _nuts_gram(q) -> torch.Tensor:
    """Kₙ = K + (σ² + jitter)·I of config 3 at the chains' positions q
    [C, 3] (the matrix whose inverse the NLL's backward forms)."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.linalg import cholesky as chol
    from gaussianprocessfundamentals_tpu_torch.models.segmented import (
        stacked_gram,
    )

    x, _ = _nuts_data(q.device, q.dtype)
    kern = gpt.Matern52Kernel(scaled=True).to(q.device)
    K = stacked_gram(kern, {"lengthscale": torch.exp(q[:, 0]),
                            "variance": torch.exp(q[:, 1])},
                     x.expand(q.shape[0], *x.shape))
    return chol.noised(K, torch.exp(q[:, 2]), 1e-8)


def _tri_kn_inv(L):
    from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import (
        tri_inverse,
    )

    L_inv = tri_inverse(L)
    return L_inv.mT @ L_inv


def phase_nuts() -> dict:
    """BASELINE config 3 (``benchmarks/run_all.py:164-260``):
    ``nuts_chains`` of 8 chains over the Matérn-5/2~s hyperposterior at
    n = 1,000 in float64, then ``NUTS_RESUMED`` ``nuts_chains_resume``
    segments; the
    host's synchronisations counted (``set_sync_debug_mode("warn")``)
    against the lock-step doublings; the gates of ``PERF.md`` §2 (finite
    log-probs, divergences, accept, split-R̂, ESS, σ², NUTS against
    ``hmc_chains``); one transition on the card against the CPU with the
    same draws; one transition under ``gpt.trace`` (torch.profiler)."""
    import tempfile
    import warnings

    from torch.autograd import DeviceType

    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.mcmc import nuts as tnuts
    from gaussianprocessfundamentals_tpu_torch.mcmc.hmc import value_and_grad
    from gaussianprocessfundamentals_tpu_torch.utils.profiling import (
        named_scope,
    )
    from gaussianprocessfundamentals_tpu_torch.utils.tree import (
        ravel_tree,
        tree_map,
    )

    logprob, u0 = _nuts_target()
    flat0, unravel = ravel_tree(u0)
    gen = torch.Generator(device="cuda").manual_seed(42)
    q0s = unravel(flat0 + 0.1 * torch.randn(
        (C_NUTS, flat0.numel()), generator=gen, dtype=flat0.dtype,
        device="cuda"))
    # why float64: the same log-probs in float32 (the sampler's energy
    # errors, which decide acceptance and divergence, are O(0.1-1))
    logprob32, _ = _nuts_target(dtype=torch.float32)
    lp64 = logprob(q0s)
    lp32 = logprob32(tree_map(lambda t: t.float(), q0s))
    f32_err = float((lp32.double() - lp64).abs().max())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t_all = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = gpt.nuts_chains(logprob, q0s, gen, num_samples=NUTS_SEG,
                                  num_warmup=NUTS_WARMUP,
                                  max_depth=NUTS_DEPTH)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    dt_first = time.perf_counter() - t_all
    syncs = sum(str(w.message).startswith(SYNC_WARNING) for w in caught)
    segs, seg_s = [res], []
    q_last = tree_map(lambda l: l[:, -1], res.samples)
    for _ in range(NUTS_RESUMED):
        t0 = time.perf_counter()
        r = gpt.nuts_chains_resume(logprob, q_last, gen, NUTS_SEG,
                                   res.step_size, res.inv_mass,
                                   max_depth=NUTS_DEPTH)
        torch.cuda.synchronize()
        seg_s.append(time.perf_counter() - t0)
        segs.append(r)
        q_last = tree_map(lambda l: l[:, -1], r.samples)
    wall = time.perf_counter() - t_all
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()

    draws = torch.cat([ravel_tree(s.samples, batch_ndim=2)[0] for s in segs],
                      dim=1)  # [C, 900, 3]
    cat = {k: torch.cat([getattr(s, k) for s in segs], dim=1).cpu()
           for k in ("accept_stat", "diverging", "num_steps", "log_probs")}
    stats = _chain_stats(draws)
    transitions = NUTS_WARMUP + NUTS_SEG * (1 + NUTS_RESUMED)
    doublings = sum(s.doublings for s in segs)
    accept = float(cat["accept_stat"].mean())
    div = float(cat["diverging"].double().mean())
    noise = float(torch.exp(draws[..., 2]).mean())
    sps_first = C_NUTS * NUTS_SEG / dt_first
    sps_resumed = C_NUTS * NUTS_SEG / float(np.mean(seg_s))
    log(f"[nuts] config 3: n={N_NUTS}, Matérn-5/2~s, {C_NUTS} chains, "
        f"max_depth {NUTS_DEPTH}, float64 (the float32 log-probs at the "
        f"starts differ by up to {f32_err:.3e}, against energy errors of "
        f"O(0.1-1) that decide acceptance); warmup {NUTS_WARMUP} + "
        f"{NUTS_SEG} draws: {dt_first:.2f} s, {sps_first:.1f} samples/s "
        f"(warmup included, as run_all.py); {NUTS_RESUMED} resumed segments "
        f"of {NUTS_SEG}: {[round(s, 2) for s in seg_s]} s, "
        f"{sps_resumed:.1f} samples/s; wall {wall:.1f} s, peak "
        f"{peak / 1e9:.3f} GB; launches {counts}")
    log(f"[nuts] step sizes {[round(float(e), 4) for e in res.step_size]}; "
        f"inverse mass (chain 0) "
        f"{[round(float(v), 5) for v in res.inv_mass[0]]}; mean accept "
        f"{accept:.4f}, divergences {int(cat['diverging'].sum())} of "
        f"{cat['diverging'].numel()} ({100 * div:.2f}%), mean leapfrogs per "
        f"draw {float(cat['num_steps'].mean()):.2f}; host reads: "
        f"{doublings} doublings over {transitions} transitions "
        f"({doublings / transitions:.2f} per transition); synchronisations "
        f"counted in the first program {syncs} (its doublings "
        f"{res.doublings})")
    for name, s in stats.items():
        log(f"[nuts] {name}: mean {s['mean']:.5f} sd {s['sd']:.5f} "
            f"split-R̂ {s['rhat']:.4f} ESS {s['ess']:.1f} "
            f"({C_NUTS} x {draws.shape[1]} draws)")
    log(f"[nuts] posterior mean σ² (noise) {noise:.5f} (truth 0.01)")

    # HMC on the same target, from the same starts
    t0 = time.perf_counter()
    hres = gpt.hmc_chains(logprob, q0s, gen, num_samples=HMC_DRAWS,
                          num_warmup=HMC_WARMUP, num_leapfrog=HMC_LEAPFROG)
    torch.cuda.synchronize()
    dt_hmc = time.perf_counter() - t0
    hstats = _chain_stats(ravel_tree(hres.samples, batch_ndim=2)[0])
    agree = {}
    for name in NUTS_PARAMS:
        a, b = stats[name], hstats[name]
        lim = 4.0 * np.hypot(a["se"], b["se"])
        agree[name] = abs(a["mean"] - b["mean"]) <= lim
        log(f"[nuts] hmc_chains {HMC_WARMUP} + {HMC_DRAWS}, {HMC_LEAPFROG} "
            f"leapfrogs: {name} mean {b['mean']:.5f} (ESS {b['ess']:.1f}) "
            f"against NUTS {a['mean']:.5f}: |diff| "
            f"{abs(a['mean'] - b['mean']):.5f}, limit 4·√(se²+se²) {lim:.5f}")
    log(f"[nuts] hmc_chains: {dt_hmc:.2f} s, mean accept "
        f"{float(hres.accept_prob.mean()):.4f}, step sizes "
        f"{[round(float(e), 4) for e in hres.step_size]}")

    # one batched transition on the card and on the CPU, the same draws
    q_card, unr = ravel_tree(q_last, batch_ndim=1)
    logprob_cpu, _ = _nuts_target(device="cpu")
    d_cpu = tnuts.generator_draws(torch.Generator().manual_seed(11),
                                  q_card.cpu(), NUTS_DEPTH)(0)
    outs = {}
    for tag, dev, lpf in (("card", "cuda", logprob),
                          ("cpu", "cpu", logprob_cpu)):
        q = q_card.to(dev)
        lpg = value_and_grad(lpf, unr)
        lp0, g0 = lpg(q)
        outs[tag] = [t.cpu() if isinstance(t, torch.Tensor) else t
                     for t in tnuts.nuts_transition(
                         lpg, NUTS_DEPTH,
                         tnuts.NUTSDraws(*(t.to(dev) for t in d_cpu)), q, lp0,
                         g0, res.step_size.to(dev), res.inv_mass.to(dev))]
    q_err = float((outs["card"][0] - outs["cpu"][0]).abs().max())
    same_steps = torch.equal(outs["card"][4], outs["cpu"][4])
    same_div = torch.equal(outs["card"][5], outs["cpu"][5])
    log(f"[nuts] one transition of {C_NUTS} chains, card against CPU "
        f"(float64, same draws): n_steps {outs['card'][4].tolist()} / "
        f"{outs['cpu'][4].tolist()}, diverging identical {same_div}, "
        f"max|q diff| {q_err:.3e} (limit 1e-8)")

    # one transition under the port's trace (torch.profiler)
    lpg = value_and_grad(logprob, unr)
    lp0, g0 = lpg(q_card)
    d_card = tnuts.generator_draws(gen, q_card, NUTS_DEPTH)(0)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with gpt.trace(tmp) as prof:
            t0 = time.perf_counter()
            with named_scope("nuts_transition"):
                out = tnuts.nuts_transition(lpg, NUTS_DEPTH, d_card, q_card,
                                            lp0, g0, res.step_size,
                                            res.inv_mass)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        trace_path = Path(tmp) / "trace.json"
        trace_mb = trace_path.stat().st_size / 1e6
        labelled = "nuts_transition" in trace_path.read_text()
    n_kernels, busy = _device_busy(prof, skip={"nuts_transition"})
    leapfrogs = 2 ** out[6] - 1  # lock step: every leaf of every doubling
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name != "nuts_transition":
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    log(f"[nuts] one transition under gpt.trace: {out[6]} doublings, "
        f"{leapfrogs} batched leapfrogs, wall {wall_us / 1e3:.2f} ms "
        f"({wall_us / 1e3 / leapfrogs:.3f} ms per leapfrog of {C_NUTS} "
        f"chains), {n_kernels} device kernels ({n_kernels / leapfrogs:.1f} "
        f"per leapfrog), device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}% of wall); Chrome trace "
        f"{trace_mb:.2f} MB, labelled {labelled}")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[nuts]   {us / 1e3:9.2f} ms  {name[:100]}")
    # the backward's Kₙ⁻¹ at the chains' shape: torch.cholesky_inverse
    # against linalg.cholesky.tri_inverse, and one whole leapfrog's lpg
    Kn = _nuts_gram(q_card)
    L = torch.linalg.cholesky(Kn)
    ms = {"cholesky_inverse": _time_ms(lambda: torch.cholesky_inverse(L), 10),
          "tri_inverse": _time_ms(lambda: _tri_kn_inv(L), 10),
          "lpg": _time_ms(lambda: lpg(q_card), 10)}
    inv_err = float((_tri_kn_inv(L) - torch.cholesky_inverse(L)).abs().max()
                    / torch.cholesky_inverse(L).abs().max())
    log(f"[nuts] Kₙ⁻¹ of {C_NUTS} x {N_NUTS}² float64 (CUDA events): "
        f"torch.cholesky_inverse {ms['cholesky_inverse']:.3f} ms, "
        f"L⁻ᵀL⁻¹ by tri_inverse {ms['tri_inverse']:.3f} ms (relative "
        f"difference {inv_err:.2e}); log-prob and gradient of the {C_NUTS} "
        f"chains {ms['lpg']:.3f} ms")

    checks = {
        "every log-prob finite": bool(torch.isfinite(cat["log_probs"]).all()),
        f"divergences <= {NUTS_DIV_MAX:.0%}": div <= NUTS_DIV_MAX,
        f"mean accept in {NUTS_ACCEPT}":
        NUTS_ACCEPT[0] <= accept <= NUTS_ACCEPT[1],
        f"max split-R̂ <= {NUTS_RHAT_MAX}":
        max(s["rhat"] for s in stats.values()) <= NUTS_RHAT_MAX,
        f"min ESS >= {NUTS_ESS_MIN}":
        min(s["ess"] for s in stats.values()) >= NUTS_ESS_MIN,
        f"posterior mean σ² in {NUTS_NOISE_BAND}":
        NUTS_NOISE_BAND[0] <= noise <= NUTS_NOISE_BAND[1],
        "NUTS and HMC agree on every posterior mean": all(agree.values()),
        "one host read per doubling": syncs == res.doublings,
        "card equals CPU": same_steps and same_div and q_err <= 1e-8,
        "trace written and labelled": labelled,
        "no kernel launched": sum(counts.values()) == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"config 3 (NUTS) checks failed: {failed}")
    return {"counts": counts}


def phase_m11() -> dict:
    """M11 on the card: ``compat.get_metric`` for every family (LL without
    an approximation, by CG, Nyström, SKC lower and upper, SKI; BIC; MSE)
    at n = 4,096 in float32 against the same metric in float64 on the card,
    within ``M11_RTOL``; a ``DataInput`` split and
    ``subset_smoothed_grid`` on the card against the CPU (float64, the same
    permutation). Phase 32's profiled transition ran through
    ``profiling.trace``."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch import compat as C

    x, y = gpt.synth_se(n=N_M11, lengthscale=0.2, noise_sd=0.1, seed=33)
    MT, MA = C.MetricType, C.MatrixApproximations
    cases = {
        "ll": ((MT.LL,), "xy"),
        "ll_cg": ((MT.LL, MA.NONE,
                   C.NumericalMatrixHandlingType.LINEAR_CONJUGATE_GRADIENT),
                  "xy"),
        "nystroem": ((MT.LL, MA.BASIC_NYSTROEM), "z"),
        "skc_lower": ((MT.LL, MA.SKC_LOWER_BOUND), "z"),
        "skc_upper": ((MT.LL, MA.SKC_UPPER_BOUND), "z"),
        "ski": ((MT.LL, MA.SKI), "grid"),
        "bic": ((MT.BIC,), "xy"),
        "mse": ((MT.MSE,), "split"),
    }
    vals, secs, counts = {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        k = gpt.params_from_numpy(
            gpt.SquaredExponentialKernel(scaled=True),
            {"lengthscale": np.float64(0.2), "variance": np.float64(1.0)},
            device="cuda", dtype=dtype)
        X = torch.tensor(x, dtype=dtype, device="cuda")
        Y = torch.tensor(y, dtype=dtype, device="cuda")
        extra = {"z": X[::16], "grid": torch.linspace(
            float(X.min()), float(X.max()), 512, dtype=dtype,
            device="cuda")[:, None]}
        for name, (args, kind) in cases.items():
            fn = C.get_metric(*args)
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "split":
                v = fn(k, X[::2], Y[::2], X[1::2], Y[1::2], M11_NOISE)
            elif kind == "xy":
                v = fn(k, X, Y, M11_NOISE)
            else:
                v = fn(k, X, Y, extra[kind], M11_NOISE)
            v = float(v)
            secs.setdefault(name, []).append(time.perf_counter() - t0)
            vals.setdefault(name, []).append(v)
            if dtype == torch.float32:
                counts[name] = _launch_counts()
    rel = {n: abs(a - b) / abs(b) for n, (a, b) in vals.items()}
    for n, (a, b) in vals.items():
        log(f"[m11] get_metric {n} n={N_M11} σ²={M11_NOISE}: float32 {a:.6f} "
            f"({secs[n][0]:.3f} s) float64 {b:.6f} ({secs[n][1]:.3f} s): "
            f"relative {rel[n]:.3e} (limit {M11_RTOL[n]:g}); float32 "
            f"launches {counts[n]}")
    total = {kk: sum(c[kk] for c in counts.values()) for kk in _wrappers()}

    perm = np.random.default_rng(0).permutation(N_M11)
    dis = {tag: gpt.DataInput.from_arrays(x, y, perm=perm,
                                          dtype=torch.float64, device=dev)
           for tag, dev in (("card", "cuda"), ("cpu", "cpu"))}
    same_split = all(torch.equal(getattr(dis["card"], a).cpu(),
                                 getattr(dis["cpu"], a))
                     for a in ("x_train", "y_train", "x_test", "y_test"))
    subs = {dev: di.subset_smoothed_grid(512) for dev, di in dis.items()}
    sub_err = float((subs["card"].y_train.cpu() - subs["cpu"].y_train)
                    .abs().max())
    sub_lim = 1e-12 * float(subs["cpu"].y_train.abs().max())
    log(f"[m11] DataInput split {dis['card'].n_train} / "
        f"{dis['card'].x_test.shape[0]} on the card equal to the CPU's "
        f"{same_split}; subset_smoothed_grid(512): max|diff| {sub_err:.3e} "
        f"(limit {sub_lim:.3e})")
    checks = {f"{n} within {M11_RTOL[n]:g}": rel[n] <= M11_RTOL[n]
              for n in rel}
    checks["split equal"] = same_split
    checks["smoothed grid equal"] = sub_err <= sub_lim
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"M11 checks failed: {failed}")
    return {"counts": total}


# --- phases 34-36: the multi-GPU slice -------------------------------------
# P = 2 gloo ranks share the one card (NCCL refuses two ranks on one GPU);
# P = 1 over NCCL checks the NCCL path. Each configuration is one spawn
# that runs the three phases' rank work; the gates are taken here.
MESH_RANKS = 2
N_MESH, MESH_STEPS, T_MESH = N_STORY, 5, 256
# phase 25's knobs (FIT_KWARGS) for fit_iterative, and fit()'s step guard
MESH_FIT_KW = dict(steps=MESH_STEPS, lr=0.05, num_probes=8, max_iters=25,
                   precond_m=256, tol=3e-3, early_exit=False, resid_guard=0.5,
                   init_noise=1e-2)
MESH_HIST_RTOL, MESH_PARAM_RTOL, NCCL_RTOL = 1e-3, 1e-2, 1e-5
N_MESH_EXPR = 20_000  # the composite's mesh matvec and VJP against K3/K4
N_BC, T_BC, BC_BLOCK = 32_768, 64, 512  # block 512: timed in PERF.md §5
BC_LS, BC_NOISE, BC_JITTER = 0.1, 1e-2, 1e-6
BC_FIT_STEPS, BC_PROBES = 3, 8
BC_NLL_RTOL = 1e-4  # against a float64 dense Cholesky of the same K
BC_PEAK_RATIO = 1.25  # peak per rank after distributed_nll / its block-rows
MC_WARMUP, MC_DRAWS, MC_LEAPFROG, MC_DEPTH = 100, 100, 16, 6
MC_P1_TOL = 1e-8  # P = 1 collective against hmc_chains/nuts_chains, C = 1
MESH_TIMEOUT = 600.0


def _bc_data():
    """Phase 35's problem: sorted x ~ U(0, 1), y = sin(8x) + 0.1ε, and the
    SE kernel at ℓ 0.1 (float32 on the card)."""
    import gaussianprocessfundamentals_tpu_torch as gpt

    g = torch.Generator().manual_seed(35)
    x = torch.sort(torch.rand(N_BC, 1, generator=g), dim=0).values
    y = torch.sin(8.0 * x[:, 0]) + 0.1 * torch.randn(N_BC, generator=g)
    k = _with_params(gpt.SquaredExponentialKernel(), {"lengthscale": BC_LS})
    return x.cuda(), y.cuda(), k


def _mesh_expr_inputs():
    """Phase 34's composite check: the Mauna Loa kernel at n = 20,000 with a
    9-column V and a 12-column cotangent."""
    g = torch.Generator().manual_seed(341)
    x = torch.sort(torch.rand(N_MESH_EXPR, 1, generator=g), dim=0).values
    V = torch.randn(N_MESH_EXPR, 9, generator=g)
    U = torch.randn(N_MESH_EXPR, 12, generator=g)
    W = torch.randn(N_MESH_EXPR, 12, generator=g)
    return (_with_params(_mauna_kernel(), MAUNA_PARAMS),
            *(t.cuda() for t in (x, V, U, W)))


def _mc_target():
    """Config 3's single-chain log posterior (``_nuts_target`` at C = 1)
    and the starts of ``MESH_RANKS`` chains: the default + 0.1·N(0, 1)."""
    from gaussianprocessfundamentals_tpu_torch.utils.tree import (
        ravel_tree,
        tree_map,
    )

    logprob, u0 = _nuts_target()
    flat0, unravel = ravel_tree(u0)
    g = torch.Generator(device="cuda").manual_seed(36)
    q0s = unravel(flat0 + 0.1 * torch.randn(
        (MESH_RANKS, flat0.numel()), generator=g, dtype=flat0.dtype,
        device="cuda"))
    one = lambda u: logprob(tree_map(lambda l: l[None], u))[0]  # noqa: E731
    return one, logprob, q0s


def _mc_generator(chain: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(3600 + chain)


def _rank_mesh_fit(mesh) -> dict:
    """Phase 34 on one rank: 5 Adam steps of ``fit_iterative(mesh=…)`` at
    N = 200,000 (the story's data, phase 25's knobs), the chunked posterior
    at 256 points under the mesh, and the composite's mesh matvec and VJP;
    launch counts, seconds per step and peak memory of this rank."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.models import iterative
    from gaussianprocessfundamentals_tpu_torch.parallel import mesh_matvec

    x, y = _trend_data(N_MESH, seed=24)
    kernel = gpt.SquaredExponentialKernel(scaled=True).cuda()
    mean = (gpt.ConstantMean() + gpt.LinearMean(dim=1)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(34)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    kp, mp, noise, hist, diag = iterative.fit_iterative(
        kernel, x, y, gen, mean=mean, mesh=mesh, return_diagnostics=True,
        **MESH_FIT_KW)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = _launch_counts()
    xt = torch.linspace(0.01, 0.99, T_MESH, device="cuda")[:, None]
    _zero_counts()
    stats = {}
    t0 = time.perf_counter()
    with torch.no_grad():
        mu, var = iterative.iterative_posterior_chunked(
            kernel, x, y - mean.mean(x), xt, noise, stats=stats, mesh=mesh)
        mu = mu + mean.mean(xt)
    torch.cuda.synchronize()
    post_s = time.perf_counter() - t0
    post_counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    kc, xc, V, U, W = _mesh_expr_inputs()
    _zero_counts()
    with torch.no_grad():
        mv = mesh_matvec.mesh_gram_matvec(kc, xc, V, mesh)
        gv = mesh_matvec.mesh_lowrank_vjp(kc, xc, U, W, mesh)
    expr_counts = _launch_counts()
    return {"hist": hist, "kp": kp, "mp": mp, "noise": noise,
            "frozen": diag["frozen_frac"], "fit_s": fit_s,
            "fit_counts": fit_counts, "mu": mu, "var": var, "stats": stats,
            "post_s": post_s, "post_counts": post_counts, "peak": peak,
            "expr_mv": mv, "expr_vjp": gv, "expr_counts": expr_counts}


def _rank_block_cyclic(mesh) -> dict:
    """Phase 35 on one rank, in float32 as a user calls it: each rank
    builds only its cyclic block-rows of K through K5 and
    ``distributed_nll`` factors them in place; ``distributed_posterior`` at
    64 points; 3 steps of ``fit_distributed`` with 8 probes; then the NLL
    and posterior on float64 inputs (not counted, not in the peak)."""
    from gaussianprocessfundamentals_tpu_torch.parallel import (
        block_cholesky as bc,
    )
    from gaussianprocessfundamentals_tpu_torch.parallel import distributed_fit

    x, y, k = _bc_data()
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        out["nll"] = bc.distributed_nll(
            bc.cyclic_gram(k, x, BC_BLOCK, mesh), y, BC_NOISE, BC_JITTER,
            mesh, block=BC_BLOCK)
    torch.cuda.synchronize()
    out["nll_s"] = time.perf_counter() - t0
    out["nll_peak"] = torch.cuda.max_memory_allocated()
    nll_counts = _launch_counts()
    xt = torch.linspace(0.005, 0.995, T_BC, device="cuda")[:, None]
    _zero_counts()
    t0 = time.perf_counter()
    out["mu"], out["var"] = bc.distributed_posterior(
        k, x, y, xt, BC_NOISE, BC_JITTER, mesh, block=BC_BLOCK)
    torch.cuda.synchronize()
    out["post_s"] = time.perf_counter() - t0
    out["post_counts"] = _launch_counts()
    import gaussianprocessfundamentals_tpu_torch as gpt

    kf = gpt.SquaredExponentialKernel().cuda()
    gen = torch.Generator(device="cuda").manual_seed(35)
    _zero_counts()
    t0 = time.perf_counter()
    kp, noise, hist = distributed_fit.fit_distributed(
        kf, x, y, mesh, gen, block=BC_BLOCK, probes=BC_PROBES,
        steps=BC_FIT_STEPS, lr=0.05)
    torch.cuda.synchronize()
    out.update(fit_s=time.perf_counter() - t0, fit_counts=_launch_counts(),
               fit_hist=hist, fit_kp=kp, fit_noise=noise,
               nll_counts=nll_counts, peak=torch.cuda.max_memory_allocated())
    # the NLL and posterior on float64 inputs (the plain Gram), for the
    # NCCL-vs-gloo agreement: P = 1 and P = 2 order their GEMMs' sums alike
    # only in float64. (A float64 fit has no card route: K2 takes float32.)
    x64, y64, k64 = x.double(), y.double(), _f64(k)
    with torch.no_grad():
        nll64 = bc.distributed_nll(
            bc.cyclic_gram(k64, x64, BC_BLOCK, mesh), y64, BC_NOISE,
            BC_JITTER, mesh, block=BC_BLOCK)
    mu64, var64 = bc.distributed_posterior(
        k64, x64, y64, xt.double(), BC_NOISE, BC_JITTER, mesh,
        block=BC_BLOCK)
    out["f64"] = {"nll": nll64, "mu": mu64, "var": var64}
    return out


def _rank_mcmc(mesh) -> dict:
    """Phase 36 on one rank: ``hmc_chains_collective`` and
    ``nuts_chains_collective``, one chain of config 3 per rank; at P = 1
    also ``hmc_chains`` / ``nuts_chains`` with C = 1 on the same draws."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_map

    one, stacked, q0s = _mc_target()
    i = mesh.index("dp")
    q0s = tree_map(lambda l: l[:mesh.size("dp")], q0s)
    _zero_counts()
    out = {}
    t0 = time.perf_counter()
    out["hmc"] = gpt.hmc_chains_collective(
        one, q0s, _mc_generator(i), mesh, num_samples=MC_DRAWS,
        num_warmup=MC_WARMUP, num_leapfrog=MC_LEAPFROG)
    torch.cuda.synchronize()
    out["hmc_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["nuts"] = tuple(gpt.nuts_chains_collective(
        one, q0s, _mc_generator(i), mesh, num_samples=MC_DRAWS,
        num_warmup=MC_WARMUP, max_depth=MC_DEPTH))
    torch.cuda.synchronize()
    out["nuts_s"] = time.perf_counter() - t0
    out["counts"] = _launch_counts()
    if mesh.size("dp") == 1:
        out["hmc_c1"] = gpt.hmc_chains(
            stacked, q0s, _mc_generator(0), num_samples=MC_DRAWS,
            num_warmup=MC_WARMUP, num_leapfrog=MC_LEAPFROG)
        out["nuts_c1"] = tuple(gpt.nuts_chains(
            stacked, q0s, _mc_generator(0), num_samples=MC_DRAWS,
            num_warmup=MC_WARMUP, max_depth=MC_DEPTH))
    return out


def _rank_multi_gpu() -> dict:
    """Every rank's share of phases 34-36 (the spawned function)."""
    import sys

    import torch.distributed as dist

    from gaussianprocessfundamentals_tpu_torch.parallel.meshes import (
        single_axis_mesh,
    )

    assert "jax" not in sys.modules
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    tp, dp = single_axis_mesh("tp"), single_axis_mesh("dp")
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "device": torch.cuda.current_device(),
            "mesh_fit": _rank_mesh_fit(tp),
            "block_cyclic": _rank_block_cyclic(tp),
            "mcmc": _rank_mcmc(dp)}


def _rel(a, b) -> float:
    a = torch.as_tensor(a).detach().cpu().double()
    b = torch.as_tensor(b).detach().cpu().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _tree_rel(a, b) -> float:
    from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves

    return max(_rel(u, v) for u, v in zip(tree_leaves(a), tree_leaves(b)))


def _single_mesh_fit() -> dict:
    """Phase 34's single-process reference: the same 5 steps on the same
    probes, the same posterior, and K3/K4 on the composite's inputs."""
    import gaussianprocessfundamentals_tpu_torch as gpt
    from gaussianprocessfundamentals_tpu_torch.models import iterative
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_expr import (
        expr_lowrank_vjp_for,
        expr_matvec_for,
    )

    x, y = _trend_data(N_MESH, seed=24)
    kernel = gpt.SquaredExponentialKernel(scaled=True).cuda()
    mean = (gpt.ConstantMean() + gpt.LinearMean(dim=1)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(34)
    t0 = time.perf_counter()
    kp, mp, noise, hist, _ = iterative.fit_iterative(
        kernel, x, y, gen, mean=mean, return_diagnostics=True, **MESH_FIT_KW)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    xt = torch.linspace(0.01, 0.99, T_MESH, device="cuda")[:, None]
    with torch.no_grad():
        mu, var = iterative.iterative_posterior_chunked(
            kernel, x, y - mean.mean(x), xt, noise)
        mu = mu + mean.mean(xt)
    kc, xc, V, U, W = _mesh_expr_inputs()
    with torch.no_grad():
        mv = expr_matvec_for(kc, xc)(V)
        gv = expr_lowrank_vjp_for(kc, xc)(U, W)
    truth = 2.0 + 3.0 * xt[:, 0] + torch.sin(8.0 * xt[:, 0])
    return {"hist": hist, "kp": kp, "mp": mp, "noise": noise, "mu": mu,
            "var": var, "fit_s": fit_s, "expr_mv": mv, "expr_vjp": gv,
            "truth": truth.cpu()}


def _bc_oracle() -> dict:
    """Phase 35's float64 oracle: the dense Cholesky of the same float32 K
    (built by K5, then cast), its NLL and posterior at 64 points."""
    from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import LOG_2PI
    from gaussianprocessfundamentals_tpu_torch.ops.cuda_dense_gram import (
        dense_gram_for,
    )

    x, y, k = _bc_data()
    xt = torch.linspace(0.005, 0.995, T_BC, device="cuda")[:, None]
    with torch.no_grad():
        K = dense_gram_for(k, x, x).double()
        K.diagonal().add_(BC_NOISE + BC_JITTER)
        L = torch.linalg.cholesky(K)
        del K
        yd = y.double()
        z = torch.linalg.solve_triangular(L, yd[:, None], upper=False)[:, 0]
        nll = (0.5 * torch.dot(z, z) + torch.log(torch.diagonal(L)).sum()
               + 0.5 * N_BC * LOG_2PI)
        K_s = dense_gram_for(k, x, xt).double()
        alpha = torch.cholesky_solve(yd[:, None], L)[:, 0]
        V = torch.linalg.solve_triangular(L, K_s, upper=False)
        mu = K_s.T @ alpha
        var = k.diag(xt).double() - (V * V).sum(0)
    return {"nll": float(nll), "mu": mu.cpu(), "var": var.cpu()}


def phase_multi_gpu() -> dict:
    """Phases 34-36 (the multi-GPU slice): P = 2 gloo ranks on the one card
    and P = 1 over NCCL, each a spawn of ``_rank_multi_gpu``; then the
    single-process references and every gate, each limit beside its
    reading."""
    from gaussianprocessfundamentals_tpu_torch.parallel.meshes import launch

    torch.cuda.empty_cache()  # the ranks share the card with this process
    runs = {}
    for backend, P in (("gloo", MESH_RANKS), ("nccl", 1)):
        t0 = time.perf_counter()
        runs[backend] = launch(_rank_multi_gpu, P, backend=backend,
                               device="cuda", timeout=MESH_TIMEOUT)
        log(f"[multi-gpu] {P} rank(s), {backend} on "
            f"{torch.cuda.get_device_name(0)} (cuda:"
            f"{[r['device'] for r in runs[backend]]}): ranks ran "
            f"{[(r['backend'], r['world']) for r in runs[backend]]} in "
            f"{time.perf_counter() - t0:.1f} s")
    gl, nc = runs["gloo"], runs["nccl"][0]
    checks = {}

    # phase 34
    ref = _single_mesh_fit()
    f0 = gl[0]["mesh_fit"]
    hist_rel = max(_rel(r["mesh_fit"]["hist"], ref["hist"]) for r in gl)
    par_rel = max(max(_tree_rel(r["mesh_fit"]["kp"], ref["kp"]),
                      _tree_rel(r["mesh_fit"]["mp"], ref["mp"]),
                      _rel(r["mesh_fit"]["noise"], ref["noise"])) for r in gl)
    nccl_rel = max(_rel(nc["mesh_fit"]["hist"], ref["hist"]),
                   _tree_rel(nc["mesh_fit"]["kp"], ref["kp"]),
                   _rel(nc["mesh_fit"]["noise"], ref["noise"]))
    rmse = float(torch.sqrt(torch.mean((f0["mu"] - ref["truth"]) ** 2)))
    resid = max(f0["stats"]["rel_resid"])
    mv_err = max(float((r["mesh_fit"]["expr_mv"] - ref["expr_mv"].cpu())
                       .abs().max()) for r in gl)
    mv_lim = K3_RTOL * float(ref["expr_mv"].abs().max())
    vjp_rel = max(_tree_rel(r["mesh_fit"]["expr_vjp"], ref["expr_vjp"])
                  for r in gl)
    per_rank = [{"K1": r["mesh_fit"]["fit_counts"]["K1"],
                 "K2": r["mesh_fit"]["fit_counts"]["K2"],
                 "s_per_step": r["mesh_fit"]["fit_s"] / MESH_STEPS,
                 "peak_GB": r["mesh_fit"]["peak"] / 1e9} for r in gl]
    log(f"[mesh-fit] N={N_MESH}, {MESH_STEPS} Adam steps of "
        f"fit_iterative(mesh=…) on {MESH_RANKS} gloo ranks: per rank "
        f"{per_rank}; single process {ref['fit_s'] / MESH_STEPS:.3f} s/step; "
        f"NCCL P=1 {nc['mesh_fit']['fit_s'] / MESH_STEPS:.3f} s/step; NLL "
        f"history {[float(f'{v:.3f}') for v in f0['hist']]} (single "
        f"{[float(f'{v:.3f}') for v in ref['hist']]}): rel {hist_rel:.2e} "
        f"(limit {MESH_HIST_RTOL}); params rel {par_rel:.2e} (limit "
        f"{MESH_PARAM_RTOL}); NCCL P=1 vs single rel {nccl_rel:.2e} (limit "
        f"{NCCL_RTOL}); skipped steps {f0['frozen']}")
    log(f"[mesh-posterior] {T_MESH} points under the mesh: "
        f"{f0['post_s']:.3f} s, CG iters {f0['stats']['iters']}, max true "
        f"rel resid {resid:.3e} (limit 1e-3), RMSE vs the noise-free function "
        f"{rmse:.5f} (limit 0.01), max|μ − single| "
        f"{float((f0['mu'] - ref['mu'].cpu()).abs().max()):.3e}, launches "
        f"per rank {[r['mesh_fit']['post_counts'] for r in gl]}")
    log(f"[mesh-expr] Mauna composite at n={N_MESH_EXPR}: mesh matvec vs "
        f"single-process K3 max|diff| {mv_err:.3e} (limit K3_RTOL·max|ref| = "
        f"{mv_lim:.3e}), mesh VJP vs K4 per-array rel {vjp_rel:.3e} (limit "
        f"{K3_RTOL}); launches per rank "
        f"{[r['mesh_fit']['expr_counts'] for r in gl]}")
    checks.update({
        "34: NLL history vs single process": hist_rel <= MESH_HIST_RTOL,
        "34: fitted params vs single process": par_rel <= MESH_PARAM_RTOL,
        "34: NCCL P=1 vs single process": nccl_rel <= NCCL_RTOL,
        "34: residual <= 1e-3": resid <= 1e-3,
        "34: RMSE < 0.01": rmse < 0.01,
        "34: no step skipped": all(r["mesh_fit"]["frozen"] == 0.0 for r in gl),
        "34: K1 and K2 on every rank": all(
            c["K1"] > 0 and c["K2"] == MESH_STEPS for c in per_rank),
        "34: composite matvec": mv_err <= mv_lim,
        "34: composite VJP": vjp_rel <= K3_RTOL,
        "34: K3 and K4 on every rank": all(
            r["mesh_fit"]["expr_counts"]["K3"] > 0
            and r["mesh_fit"]["expr_counts"]["K4"] > 0 for r in gl),
    })

    # phase 35
    orc = _bc_oracle()
    b0 = gl[0]["block_cyclic"]
    nll_rel = abs(float(b0["nll"]) - orc["nll"]) / abs(orc["nll"])
    mu_err = float((b0["mu"].double() - orc["mu"]).abs().max())
    var_err = float((b0["var"].double() - orc["var"]).abs().max())
    mu_lim = 1e-3 * float(orc["mu"].abs().max())
    var_lim = 5e-2 * float(orc["var"].abs().max())
    fh = [float(v) for v in b0["fit_hist"]]
    bn = nc["block_cyclic"]
    rows_bytes = N_BC * N_BC * 4 / MESH_RANKS  # float32 block-rows per rank
    nc_nll_rel = abs(float(bn["nll"]) - orc["nll"]) / abs(orc["nll"])
    nc_mu_err = float((bn["mu"].double() - orc["mu"]).abs().max())
    nc_var_err = float((bn["var"].double() - orc["var"]).abs().max())
    # P = 1 against P = 2: the float32 NLL and fit history, and the float64
    # NLL and posterior (float32's μ and var are read, not gated: P = 1
    # and 2 round apart there, and var is a difference of numbers near 1)
    f32_p12 = {k: _rel(bn[k], b0[k]) for k in ("nll", "mu", "var", "fit_hist")}
    f64_p12 = {k: _rel(bn["f64"][k], b0["f64"][k])
               for k in ("nll", "mu", "var")}
    bc_nccl = max(*f64_p12.values(), f32_p12["nll"], f32_p12["fit_hist"])
    log(f"[block-cyclic] n={N_BC} (SE ℓ {BC_LS}, σ² {BC_NOISE}, block "
        f"{BC_BLOCK}, float32) on {MESH_RANKS} gloo ranks, K from each "
        f"rank's block-rows (K5), factored in place: distributed_nll "
        f"{float(b0['nll']):.4f} vs float64 dense {orc['nll']:.4f}: rel "
        f"{nll_rel:.2e} (limit {BC_NLL_RTOL}); {b0['nll_s']:.3f} s (NCCL P=1 "
        f"{bn['nll_s']:.3f} s), peak per rank after it "
        f"{[r['block_cyclic']['nll_peak'] / 1e9 for r in gl]} GB (limit "
        f"{BC_PEAK_RATIO} x its block-rows' {rows_bytes / 1e9:.3f} GB); "
        f"posterior at {T_BC} points {b0['post_s']:.3f} s: max|Δμ| "
        f"{mu_err:.3e} (limit {mu_lim:.3e}), max|Δvar| {var_err:.3e} (limit "
        f"{var_lim:.3e}); launches per rank (nll, posterior) "
        f"{[(r['block_cyclic']['nll_counts'], r['block_cyclic']['post_counts']) for r in gl]}; "
        f"peak per rank {[r['block_cyclic']['peak'] / 1e9 for r in gl]} GB")
    log(f"[fit-distributed] {BC_FIT_STEPS} steps, {BC_PROBES} probes: NLL "
        f"{[float(f'{v:.3f}') for v in fh]}, {b0['fit_s'] / BC_FIT_STEPS:.3f} "
        f"s/step, ℓ {float(b0['fit_kp']['lengthscale']):.4f}, σ² "
        f"{float(b0['fit_noise']):.5f}; launches per rank "
        f"{[r['block_cyclic']['fit_counts'] for r in gl]}")
    log(f"[block-cyclic-nccl] NCCL P=1, float32: NLL rel {nc_nll_rel:.2e} "
        f"(limit {BC_NLL_RTOL}), max|Δμ| {nc_mu_err:.3e} (limit "
        f"{mu_lim:.3e}), max|Δvar| {nc_var_err:.3e} (limit {var_lim:.3e}) "
        f"from the float64 oracle; fit NLL "
        f"{[float(f'{v:.3f}') for v in bn['fit_hist']]}; NCCL P=1 vs gloo "
        f"P=2 rel (limit {NCCL_RTOL} on all but float32 μ and var), "
        f"float64 inputs "
        f"{ {k: f'{v:.2e}' for k, v in f64_p12.items()} } (float64 NLL "
        f"{float(b0['f64']['nll']):.4f}), float32 "
        f"{ {k: f'{v:.2e}' for k, v in f32_p12.items()} }")
    checks.update({
        "35: NLL vs float64 dense": nll_rel <= BC_NLL_RTOL,
        "35: posterior mean": mu_err <= mu_lim,
        "35: posterior variance": var_err <= var_lim,
        "35: fit history finite and ends below its start":
        all(np.isfinite(fh)) and fh[-1] < fh[0],
        "35: NCCL P=1 NLL vs float64 dense": nc_nll_rel <= BC_NLL_RTOL,
        "35: NCCL P=1 posterior": nc_mu_err <= mu_lim
        and nc_var_err <= var_lim,
        "35: NCCL P=1 fit history finite and falls": bool(
            torch.isfinite(bn["fit_hist"]).all())
        and float(bn["fit_hist"][-1]) < float(bn["fit_hist"][0]),
        "35: NCCL P=1 vs gloo P=2": bc_nccl <= NCCL_RTOL,
        "35: one copy of the block-rows per rank": all(
            r["block_cyclic"]["nll_peak"] <= BC_PEAK_RATIO * rows_bytes
            for r in gl),
        "35: K5 builds the block-rows on every rank": all(
            r["block_cyclic"]["nll_counts"]["K5"] > 0 for r in gl),
        "35: K2 in fit_distributed on every rank": all(
            r["block_cyclic"]["fit_counts"]["K2"] == BC_FIT_STEPS for r in gl),
    })

    # phase 36
    # every rank's copy of every chain's step size: one value per sampler
    same_eps = all(
        bool((v == v[0]).all()) for v in (
            torch.cat([r["mcmc"][k][2].reshape(-1) for r in gl])
            for k in ("hmc", "nuts")))
    m0 = gl[0]["mcmc"]
    acc = {k: float(m0[k][1].double().mean()) for k in ("hmc", "nuts")}
    finite = all(bool(torch.isfinite(m0[k][i]).all())
                 for k, i in (("hmc", 3), ("nuts", 5)))
    p1 = max(_tree_rel(tuple(nc["mcmc"]["hmc"]), tuple(nc["mcmc"]["hmc_c1"])),
             _tree_rel(nc["mcmc"]["nuts"][:7], nc["mcmc"]["nuts_c1"][:7]))
    log(f"[mcmc-collective] config 3 (n={N_NUTS}, Matérn-5/2, float64), one "
        f"chain per rank on {MESH_RANKS} gloo ranks: HMC "
        f"{MC_WARMUP}+{MC_DRAWS} x {MC_LEAPFROG} leapfrogs in "
        f"{m0['hmc_s']:.1f} s, accept {acc['hmc']:.3f}, step size "
        f"{m0['hmc'][2].tolist()}; NUTS {MC_WARMUP}+{MC_DRAWS} (max_depth "
        f"{MC_DEPTH}) in {m0['nuts_s']:.1f} s, accept {acc['nuts']:.3f}, step "
        f"size {m0['nuts'][2].tolist()}, leapfrogs/draw "
        f"{float(m0['nuts'][3].double().mean()):.1f}; accept limits "
        f"{NUTS_ACCEPT}; bitwise-same step size on every rank: {same_eps}; "
        f"NCCL P=1 vs hmc_chains/nuts_chains C=1 max rel {p1:.2e} (limit "
        f"{MC_P1_TOL})")
    checks.update({
        "36: bitwise-same step size": same_eps,
        "36: log-probs finite": finite,
        "36: accept in range": all(NUTS_ACCEPT[0] <= a <= NUTS_ACCEPT[1]
                                   for a in acc.values()),
        "36: P=1 equals C=1": p1 <= MC_P1_TOL,
    })
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"multi-GPU checks failed: {failed}")

    def sum_counts(key_of):
        return {k: sum(key_of(r)[k] for r in gl) for k in _wrappers()}

    paths = {
        "mesh_fit_200k": lambda r: r["mesh_fit"]["fit_counts"],
        "mesh_posterior_200k": lambda r: r["mesh_fit"]["post_counts"],
        "block_cyclic_32k": lambda r: {
            k: r["block_cyclic"]["nll_counts"][k]
            + r["block_cyclic"]["post_counts"][k] for k in _wrappers()},
        "fit_distributed_32k": lambda r: r["block_cyclic"]["fit_counts"],
        "mcmc_collective": lambda r: r["mcmc"]["counts"],
    }
    return {"counts": {p: sum_counts(f) for p, f in paths.items()},
            "by_rank": {p: [f(r) for r in gl] for p, f in paths.items()}}


def _kernel_entry(name, source, replaces, by_path, worst, times) -> dict:
    ms, plain_ms, bound_ms, bound_by = times
    return {"name": name, "route": "cuda",
            "source": f"gaussianprocessfundamentals_tpu_torch/csrc/{source}",
            "replaces": f"gaussianprocessfundamentals_tpu/ops/{replaces}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": worst[0], "max_rel_err": worst[1], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def main() -> None:
    smi = phase_device()
    phase_build()
    k1_worst = phase_kernel_check()
    phase_oracle()
    main_res = phase_main()
    k2_worst = phase_k2_check()
    phase_fit_oracle()
    fit_res = phase_fit()
    fit_time = phase_fit_time(fit_res["x"])
    phase_profile(fit_res["x"], fit_res["y"])
    k3_worst = phase_k3_check()
    k4_worst = phase_k4_check()
    phase_expr_oracle()
    expr_fit = phase_expr_fit()
    expr_serve = phase_expr_serve(expr_fit)
    expr_time = phase_expr_time(expr_fit["x"])
    _profile_step(_mauna_model, expr_fit["x"], expr_fit["y"], "expr-profile")
    k56_worst = phase_k56_check()
    dense = phase_dense_serve()
    seg = phase_segmented()
    part = phase_partitioned(seg.pop("segments"))
    k56_time = phase_k56_time()
    cp = phase_changepoint()
    var_gate = phase_var_gate()
    story = phase_story_200k()
    ny = phase_nystroem()
    phase_skc_ski()
    svgp_res = phase_svgp()
    pw = phase_pathwise()
    search = phase_search()
    batched = phase_batched_fit()
    nuts = phase_nuts()
    m11 = phase_m11()
    multi = phase_multi_gpu()
    k1_worst = _worse(_worse(k1_worst, main_res["worst"]), fit_time["k1_worst"])
    k2_worst = _worse(k2_worst, fit_time["worst"])
    k3_worst = _worse(k3_worst, expr_time["k3_worst"])
    k4_worst = _worse(k4_worst, expr_time["k4_worst"])
    k56_worst = {k: _worse(_worse(v, k56_time["worst"][k]), ny["worst"][k])
                 for k, v in k56_worst.items()}
    k56_worst["K5"] = _worse(k56_worst["K5"], svgp_res["worst"])
    k56_worst["K6"] = _worse(k56_worst["K6"], pw["worst"])
    dense_counts = {k: sum(c[k] for c in dense["counts"].values())
                    for k in _wrappers()}
    paths = {"posterior": main_res["counts"], "fit": fit_res["counts"],
             "composite_fit": expr_fit["counts"],
             "composite_posterior": expr_serve["counts"],
             "dense_posterior": dense_counts,
             "segmented": seg["counts"], "partitioned": part["counts"],
             "changepoint_posterior": cp["counts"],
             "var_gate_50k": var_gate["counts"], "story_200k": story["counts"],
             "nystroem_posterior": ny["counts"]["se"],
             "nystroem_posterior_mat52": ny["counts"]["mat52"],
             "nystroem_posterior_m10000": ny["counts"][f"se_m{M_NY_RATIO}"],
             "svgp_predict": svgp_res["counts"], "pathwise": pw["counts"],
             "search": search["counts"], "batched_fit": batched["counts"],
             "nuts_config3": nuts["counts"], "get_metric": m11["counts"],
             **multi["counts"]}
    by_path = {k: {p: c[k] for p, c in paths.items()} for k in _wrappers()}
    by_rank = {k: {p: [c[k] for c in cs] for p, cs in multi["by_rank"].items()}
               for k in _wrappers()}
    k1_widths = {1: main_res["times"][1], R_CG: fit_time["k1"],
                 256: main_res["times"][256]}
    k1 = _kernel_entry("fused_gram_matvec_cross", "gram_matvec.cu",
                       "pallas_gram.py:252", by_path["K1"], k1_worst,
                       k1_widths[256])
    k1["ms_by_width"] = {str(r): t[0] for r, t in k1_widths.items()}
    k1["bound_ms_by_width"] = {str(r): t[2] for r, t in k1_widths.items()}
    k3 = _kernel_entry("expr_gram_matvec_cross", "expr_matvec.cu",
                       "pallas_expr.py:394", by_path["K3"], k3_worst,
                       expr_time["k3_256"])
    k3["ms_by_width"] = {str(r): expr_time[f"k3_{r}"][0] for r in (1, R_CG, 256)}
    k3["bound_ms_by_width"] = {str(r): expr_time[f"k3_{r}"][2]
                               for r in (1, R_CG, 256)}
    k56 = []
    for name, fn, line in (("K5", "se_gram", 67), ("K6", "matern_gram", 142)):
        shapes = k56_time[name]
        entry = _kernel_entry(fn, "dense_gram.cu", f"pallas_gram.py:{line}",
                              by_path[name], k56_worst[name],
                              shapes[f"{N_DENSE}^2"][:4])
        for i, key in enumerate(("ms", "plain_ms", "bound_ms", "bound_by",
                                 "cholesky_ms", "call_ms")):
            entry[f"{key}_by_shape"] = {t: v[i] for t, v in shapes.items()}
        entry["dense_posterior_ms"] = dense["se" if name == "K5" else "mat52"]
        k56.append(entry)
    k2 = _kernel_entry("fused_lowrank_vjp_cross", "lowrank_vjp.cu",
                       "pallas_gram.py:398", by_path["K2"], k2_worst,
                       (fit_time["ms"], fit_time["plain_ms"],
                        fit_time["bound_ms"], fit_time["bound_by"]))
    k4 = _kernel_entry("expr_lowrank_vjp_cross", "expr_vjp.cu",
                       "pallas_expr.py:481", by_path["K4"], k4_worst,
                       expr_time["k4"])
    for entry in (k2, k4):  # the rank-273 cotangent product's rate
        entry["product_tflops"] = (2 * N_MAIN * N_MAIN * R_MAIN
                                   / (entry["ms"] * 1e-3) / 1e12)
    for name, entry in zip(("K1", "K2", "K3", "K4", "K5", "K6"),
                           (k1, k2, k3, k4, *k56)):
        # the multi-GPU paths' launches on each of the P = 2 gloo ranks
        entry["launches_by_rank"] = by_rank[name]
    log(smi)
    log(json.dumps({"kernels": [k1, k2, k3, k4, *k56]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
