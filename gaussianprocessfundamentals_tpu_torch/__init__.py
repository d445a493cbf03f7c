"""gaussianprocessfundamentals_tpu_torch — the PyTorch/CUDA port of the GP engine.

Exact GPs with composite kernels (Sum, Product, ChangePoint and Partition
of SE, periodic, linear, Matérn, rational-quadratic, constant and
white-noise leaves) and the JAX package's seven means and their operators,
fitted and served at any n, sampled, and segmented (``BlockwiseGP``,
``PartitionedGP``, ``fit_segments_vmapped``). Below 8k training rows
``fit`` runs L-BFGS on the dense Cholesky NLL (or its k-fold mean); from
there on Adam over the matrix-free iterative NLL (mBCG solves, SLQ
log-determinant, a low-rank gradient cotangent). Posteriors are dense below
20k rows and matrix-free chunked mBCG from there on. ``fit`` also takes
O(nm²) approximation objectives (``approximation=`` Nyström, the SKC
bounds or SKI, with trainable inducing inputs; the facade then serves the
projected-process posterior), SciPy's BFGS and CG (``method="scipy-bfgs"``,
``"scipy-cg"``); ``fit_batch_independent`` fits a batch of independent
problems as one program, and ``fit`` takes instance-stacked [b, n, d]
input with one parameter set shared by the instances. Beside the exact GP: SVGP (``fit_svgp``,
``svgp_predict``, the minibatch and collapsed ELBOs), random-Fourier-
feature prior draws and pathwise posterior samples
(``pathwise_posterior_samples``), and a greedy BIC search over kernel
expressions (``greedy_kernel_search``); HMC and NUTS over the
hyperparameters with the chains on a batch axis (``hmc_chains``,
``nuts_chains`` on ``make_stacked_nll``, resumable with
``nuts_chains_resume``; split-R̂ and ESS), and the reference's data,
metric-factory (``compat``), profiling and plotting helpers. Across
processes (``parallel``: one process per rank on ``torch.distributed``,
``launch`` or ``torchrun``; gloo on the CPU and for P ranks on one GPU,
NCCL for one rank per GPU): ``fit_iterative``, ``fit`` and the chunked
posterior with ``mesh=`` (each rank's row panel of K·V), the block-cyclic
distributed Cholesky (``distributed_nll``, ``distributed_posterior``,
``fit_distributed``), and HMC/NUTS with one chain per rank and a
collectively adapted step size (``hmc_chains_collective``,
``nuts_chains_collective``). On the GPU the work runs in
hand-written CUDA kernels: the dense route's Grams (and the Nyström posterior's) in
``csrc/dense_gram.cu`` (SE and Matérn leaves, K + (σ² + jitter)·I in one
pass); above 40k rows, where K is never formed, Gram·V in
``csrc/gram_matvec.cu`` and the gradient's low-rank contraction in
``csrc/lowrank_vjp.cu`` for SE and Matérn leaves, and for any Sum/Product
expression in kernels generated from its AST (``ops/expr_codegen.py`` into
``csrc/expr_matvec.cu`` and ``csrc/expr_vjp.cu``); in plain PyTorch on the
CPU, and on the GPU for the covariances those kernels do not cover
(ChangePoint, Partition, d > 8). Checkpoints are the JAX package's format,
both ways (``save``/``load``).

Quick start::

    import torch
    import gaussianprocessfundamentals_tpu_torch as gpt
    torch.set_float32_matmul_precision("highest")
    gp = gpt.GaussianProcess(gpt.SquaredExponentialKernel(scaled=True),
                             gpt.ConstantMean() + gpt.LinearMean(dim=1))
    gp.fit(x, y, method="auto", optimize_noise=True, noise=1e-2)
    post = gp.posterior(x_test)

The facade runs on the GPU unless given ``device="cpu"``.
"""
from gaussianprocessfundamentals_tpu_torch.config import (
    DEFAULT_CONFIG,
    ChangePointGate,
    GPConfig,
)
from gaussianprocessfundamentals_tpu_torch import compat
from gaussianprocessfundamentals_tpu_torch.data.datasets import (
    BatchDataInput,
    DataInput,
    MinMaxNormalization,
    load_csv,
    load_named,
    synth_mauna_loa,
    synth_se,
)
from gaussianprocessfundamentals_tpu_torch.fit.fit import (
    FitResult,
    fit,
    fit_batch_independent,
    make_kfold_nll,
    make_nll,
    make_stacked_nll,
)
from gaussianprocessfundamentals_tpu_torch.kernels.base import (
    Kernel,
    kernel_from_dict,
)
from gaussianprocessfundamentals_tpu_torch.kernels.leaves import (
    ConstantKernel,
    LinearKernel,
    Matern32Kernel,
    Matern52Kernel,
    PeriodicKernel,
    RationalQuadraticKernel,
    RBFKernel,
    SquaredExponentialKernel,
    WhiteNoiseKernel,
)
from gaussianprocessfundamentals_tpu_torch.kernels.operators import (
    ChangePoint,
    Operator,
    Product,
    Sum,
)
from gaussianprocessfundamentals_tpu_torch.kernels.partition import (
    BoxPartitioning,
    DistancePartitioning,
    Partition,
)
from gaussianprocessfundamentals_tpu_torch.mcmc.hmc import (
    HMCResult,
    effective_sample_size,
    hmc,
    hmc_chains,
    hmc_chains_collective,
    potential_scale_reduction,
)
from gaussianprocessfundamentals_tpu_torch.mcmc.nuts import (
    NUTSResult,
    nuts,
    nuts_chains,
    nuts_chains_collective,
    nuts_chains_resume,
    nuts_resume,
)
from gaussianprocessfundamentals_tpu_torch.means.functions import (
    ConstantMean,
    ExponentialMean,
    LinearMean,
    LogitMean,
    MeanChangePoint,
    MeanFunction,
    MeanProduct,
    MeanSum,
    ZeroMean,
    mean_from_dict,
)
from gaussianprocessfundamentals_tpu_torch.models.exact import (
    GaussianProcess,
    Posterior,
    posterior,
    sample_posterior,
    sample_prior,
)
from gaussianprocessfundamentals_tpu_torch.models.iterative import (
    fit_iterative,
    iterative_nll_and_grad,
    iterative_posterior,
    iterative_posterior_chunked,
    iterative_posterior_mean,
)
from gaussianprocessfundamentals_tpu_torch.models.rff import (
    pathwise_posterior_samples,
    rff_features,
    rff_init,
    rff_prior_sample,
)
from gaussianprocessfundamentals_tpu_torch.models.search import (
    greedy_kernel_search,
)
from gaussianprocessfundamentals_tpu_torch.models.segmented import (
    BlockwiseGP,
    PartitionedGP,
    fit_segments_vmapped,
)
from gaussianprocessfundamentals_tpu_torch.models.svgp import (
    SVGPParams,
    collapsed_elbo,
    fit_svgp,
    svgp_elbo,
    svgp_predict,
)
from gaussianprocessfundamentals_tpu_torch.parallel.block_cholesky import (
    distributed_chol_solve,
    distributed_cholesky,
    distributed_nll,
    distributed_posterior,
)
from gaussianprocessfundamentals_tpu_torch.parallel.distributed_fit import (
    distributed_nll_value_and_grad,
    fit_distributed,
)
from gaussianprocessfundamentals_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
)
from gaussianprocessfundamentals_tpu_torch.parallel.mesh_matvec import (
    mesh_gram_matvec,
    mesh_lowrank_vjp,
)
from gaussianprocessfundamentals_tpu_torch.parallel.meshes import (
    Mesh,
    init_multihost,
    launch,
    make_mesh,
    single_axis_mesh,
)
from gaussianprocessfundamentals_tpu_torch.utils.auxiliary import (
    SimilarityTransform,
    deserialize_params,
    serialize_params,
    similarity_from_distance,
    unique_rows,
)
from gaussianprocessfundamentals_tpu_torch.utils.checkpoint import (
    load,
    params_from_numpy,
    rff_state_from_numpy,
    save,
    stacked_params_from_numpy,
    svgp_params_from_numpy,
    tree_from_numpy,
)
from gaussianprocessfundamentals_tpu_torch.utils.profiling import (
    StepLogger,
    enable_debug_checks,
    timed,
    trace,
)
from gaussianprocessfundamentals_tpu_torch.viz.plots import (
    plot_posterior,
    plot_prior_samples,
)

__version__ = "0.1.0"
