"""gaussianprocessfundamentals_tpu_torch — the PyTorch/CUDA port of the GP engine.

The first slice of the port: serving exact-GP posteriors at any n for SE
and Matérn kernels. Below 20k training rows the posterior is a dense
Cholesky; from there on it is the matrix-free preconditioned mBCG route,
whose Gram·V products run in a hand-written CUDA kernel on the GPU
(``ops/cuda_gram.py``, ``csrc/gram_matvec.cu``) and in plain PyTorch on the
CPU. Hyperparameters come from a checkpoint of the JAX package
(``utils.checkpoint.load``) or are set on the kernel module.

Quick start::

    import torch
    import gaussianprocessfundamentals_tpu_torch as gpt
    torch.set_float32_matmul_precision("highest")
    k = gpt.SquaredExponentialKernel()
    gpt.params_from_numpy(k, {"lengthscale": np.float32(0.1)})
    gp = gpt.GaussianProcess(k, noise=1e-2, device="cuda").set_data(x, y)
    post = gp.posterior(x_test)
"""
from gaussianprocessfundamentals_tpu_torch.config import DEFAULT_CONFIG, GPConfig
from gaussianprocessfundamentals_tpu_torch.kernels.base import (
    Kernel,
    kernel_from_dict,
)
from gaussianprocessfundamentals_tpu_torch.kernels.leaves import (
    Matern32Kernel,
    Matern52Kernel,
    RBFKernel,
    SquaredExponentialKernel,
)
from gaussianprocessfundamentals_tpu_torch.means.functions import (
    MeanFunction,
    ZeroMean,
    mean_from_dict,
)
from gaussianprocessfundamentals_tpu_torch.models.exact import (
    GaussianProcess,
    Posterior,
    posterior,
)
from gaussianprocessfundamentals_tpu_torch.models.iterative import (
    iterative_posterior,
    iterative_posterior_chunked,
    iterative_posterior_mean,
)
from gaussianprocessfundamentals_tpu_torch.utils.checkpoint import (
    load,
    params_from_numpy,
)

__version__ = "0.1.0"
