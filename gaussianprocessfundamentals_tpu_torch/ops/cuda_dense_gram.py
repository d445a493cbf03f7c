"""The materialised Gram kernels K5 (SE) and K6 (Matérn) and the router
that hands them every Gram the dense and serving routes build without a
gradient.

Counterpart of ``gaussianprocessfundamentals_tpu/ops/pallas_gram.py``:
``se_gram`` (``:67``) and ``matern_gram`` (``:142``). The TPU kernels become
the hand-written CUDA kernel in ``csrc/dense_gram.cu`` (sm_90a, bound with
ctypes); its source note says what bounds it and how it is laid out. Names,
argument order and the semantics are the JAX package's: any input width d,
the Matérn in its Euclidean form, and ``diag_add`` on the global diagonal
(row index = column index) when it is positive, on a non-square build too.
The lengthscale, variance and ``diag_add`` are Python floats or 0-d
tensors; tensors are read on the device, as the TPU kernels read their
``scal`` operand, so a build makes no read on the host.

Routing is by the device and dtype of the tensors and the kernel's type,
never by a setting or a caught failure:

* CPU tensors take the plain versions, from direct per-dimension
  differences as the kernel sums them;
* CUDA float32 tensors launch the kernel;
* :func:`dense_gram_for` sends SE leaves (any d, ARD by scaling x) and
  Matérn leaves at d = 1 with a scalar lengthscale (the leaves' Matérn is
  Manhattan, which is the Euclidean form only at d = 1) to the kernels,
  and every other expression, float64 and batched inputs to
  ``kernel.gram`` plus the diagonal, as the JAX package's dense route does
  through XLA.

Forward-only, as the TPU kernels were: the wrappers refuse inputs that
require grad, and no gradient path calls the router.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from gaussianprocessfundamentals_tpu_torch.linalg.cholesky import (
    add_diag,
    effective_jitter_of_diag,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import _k1_kind

_KINDS = {"se": 0, "mat32": 1, "mat52": 2}
_NU = {"32": "mat32", "52": "mat52"}


@functools.lru_cache(maxsize=None)
def _lib():
    from gaussianprocessfundamentals_tpu_torch.ops import cuda_build

    fn = cuda_build.load("dense_gram.cu").gpf_dense_gram
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _add_global_diag(K: torch.Tensor, diag_add) -> torch.Tensor:
    """K plus ``diag_add`` at (k, k) for k < min(n, m), where it is
    positive (the TPU kernels' condition); a tensor ``diag_add`` is tested
    on its device."""
    if torch.is_tensor(diag_add):
        diag_add = diag_add.to(dtype=K.dtype, device=K.device)
        diag_add = torch.where(diag_add > 0, diag_add,
                               torch.zeros_like(diag_add))
    elif not diag_add > 0.0:
        return K
    K = K.clone()
    K.diagonal(dim1=-2, dim2=-1).add_(diag_add)
    return K


def _sq_dists(x1, x2):
    """Squared Euclidean distances [n, m] summed from direct per-dimension
    differences, as the kernel sums them; the leaves' ``gram`` expands
    |a|² − 2ab + |b|² at d > 1, which in float32 loses up to ~5e-5 of an
    entry at ℓ = 0.1."""
    d2 = torch.zeros((x1.shape[0], x2.shape[0]), dtype=x1.dtype,
                     device=x1.device)
    for k in range(x1.shape[-1]):
        diff = x1[:, k, None] - x2[None, :, k]
        d2 = d2 + diff * diff
    return d2


def plain_se_gram(x1, x2, lengthscale, variance=1.0, diag_add=0.0):
    """K5 in plain PyTorch: var·exp(−½‖x1−x2‖²/ℓ²), plus ``diag_add`` on
    the global diagonal."""
    ls = torch.as_tensor(lengthscale, dtype=x1.dtype, device=x1.device)
    return _add_global_diag(
        variance * torch.exp(-0.5 * _sq_dists(x1, x2) / (ls * ls)), diag_add)


def plain_matern_gram(x1, x2, lengthscale, variance=1.0, diag_add=0.0,
                      nu: str = "52"):
    """K6 in plain PyTorch: the Euclidean Matérn-3/2 or -5/2 at any d,
    f = √3·r/|ℓ| or √5·r/|ℓ| with r = ‖x1 − x2‖, times ``variance``, plus
    ``diag_add`` on the global diagonal."""
    ls = torch.as_tensor(lengthscale, dtype=x1.dtype, device=x1.device)
    f = (math.sqrt(3.0) if nu == "32" else math.sqrt(5.0)) * torch.sqrt(
        _sq_dists(x1, x2)) / torch.abs(ls)
    poly = 1.0 + f if nu == "32" else 1.0 + f + f * f / 3.0
    return _add_global_diag(variance * poly * torch.exp(-f), diag_add)


def _device_scalars(name, device, values):
    """(ℓ, σ², diag_add) as a float32 [3] tensor on ``device`` when any of
    them is a tensor (built by torch ops, no host read), else None."""
    if not any(torch.is_tensor(v) for v in values):
        return None
    parts = []
    for v in values:
        if not torch.is_tensor(v):
            parts.append(torch.full((), float(v), dtype=torch.float32,
                                    device=device))
        elif v.numel() != 1:
            raise ValueError(f"{name}: lengthscale, variance and diag_add "
                             f"must be scalars, got shape {tuple(v.shape)}")
        else:
            parts.append(v.detach().to(device=device,
                                       dtype=torch.float32).reshape(()))
    return torch.stack(parts)


def _on(device):
    """Context that makes ``device`` current, unless it already is."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _launch(name, x1, x2, lengthscale, variance, diag_add, kind):
    """Check the inputs (metadata only), launch the kernel on the current
    stream, return the [n, m] Gram."""
    if x1.device != x2.device or x1.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x1.device} and {x2.device}; "
                         "need all on the CPU or all on one CUDA device")
    scalars = (lengthscale, variance, diag_add)
    if x1.requires_grad or x2.requires_grad or any(
            torch.is_tensor(p) and p.requires_grad for p in scalars):
        raise RuntimeError(f"{name} is forward-only (it has no VJP): its "
                           "inputs must not require grad")
    if x1.dtype != torch.float32 or x2.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 tensors, got {x1.dtype} and "
                        f"{x2.dtype}")
    if x1.ndim != 2 or x2.ndim != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"{name}: x1 and x2 must be [n, d] and [m, d], got "
                         f"{tuple(x1.shape)} and {tuple(x2.shape)}")
    n, d = x1.shape
    m = x2.shape[0]
    scal = _device_scalars(name, x1.device, scalars)
    values = (0.0, 0.0, 0.0) if scal is not None else map(float, scalars)
    x1c, x2c = x1.contiguous(), x2.contiguous()
    out = torch.empty((n, m), dtype=torch.float32, device=x1.device)
    with _on(x1.device):
        err = _lib()(x1c.data_ptr(), x2c.data_ptr(), out.data_ptr(), n, m, d,
                     _KINDS[kind], None if scal is None else scal.data_ptr(),
                     *values, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gpf_dense_gram launch failed: cudaError {err}")
    return out


def se_gram(x1, x2, lengthscale, variance=1.0, diag_add=0.0):
    """The SE Gram var·exp(−½‖x1−x2‖²/ℓ²), plus ``diag_add`` on the global
    diagonal when positive. x1 [n, d], x2 [m, d] float32, any d → [n, m];
    the scalars are floats or 0-d tensors.

    CPU tensors take :func:`plain_se_gram`; CUDA tensors launch K5 on the
    current stream and add one to ``se_gram.launches``."""
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return plain_se_gram(x1, x2, lengthscale, variance, diag_add)
    out = _launch("se_gram", x1, x2, lengthscale, variance, diag_add, "se")
    se_gram.launches += 1
    return out


se_gram.launches = 0


def matern_gram(x1, x2, lengthscale, variance=1.0, diag_add=0.0,
                nu: str = "52"):
    """The Matérn-3/2 (``nu="32"``) or -5/2 (``"52"``) Gram in its Euclidean
    form, plus ``diag_add`` on the global diagonal when positive. x1 [n, d],
    x2 [m, d] float32, any d → [n, m]; the scalars are floats or 0-d
    tensors.

    CPU tensors take :func:`plain_matern_gram`; CUDA tensors launch K6 on
    the current stream and add one to ``matern_gram.launches``."""
    if nu not in _NU:
        raise ValueError(f"nu must be '32' or '52', got {nu!r}")
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return plain_matern_gram(x1, x2, lengthscale, variance, diag_add, nu)
    out = _launch("matern_gram", x1, x2, lengthscale, variance, diag_add,
                  _NU[nu])
    matern_gram.launches += 1
    return out


matern_gram.launches = 0


def _kernel_route(kernel, x1):
    """(wrapper, extra keyword arguments) for a leaf K5 or K6 covers on
    x1's device and dtype, else None: the leaves K1 covers
    (:func:`.cuda_gram._k1_kind`: SE at any d, Matérn at d = 1 with a
    scalar lengthscale)."""
    if x1.device.type != "cuda" or x1.dtype != torch.float32 or x1.ndim != 2:
        return None
    kind = _k1_kind(kernel, x1.shape[-1])
    if kind is None:
        return None
    if kind == "se":
        return se_gram, {}
    return matern_gram, {"nu": "32" if kind == "mat32" else "52"}


def dense_gram_for(kernel, x1, x2, diag_add=0.0):
    """K(x1, x2) at the kernel's installed hyperparameters, plus
    ``diag_add`` on the diagonal of a square build (x1 and x2 of the same
    length): K5 or K6 for the leaves they cover on CUDA float32, else
    ``kernel.gram`` plus the diagonal.

    ``diag_add`` (≥ 0) is a float or a 0-d tensor, or on the
    ``kernel.gram`` route a tensor with the batch shape. On the kernels'
    route nothing is read to the host: the hyperparameters and a tensor
    ``diag_add`` reach the kernel on the device. ARD SE is covered by
    scaling x by 1/ℓ first, as ``gram`` does."""
    add = torch.is_tensor(diag_add) or diag_add != 0.0
    if add and x1.shape[-2] != x2.shape[-2]:
        raise ValueError("dense_gram_for: diag_add needs a square build, got "
                         f"{x1.shape[-2]} x {x2.shape[-2]}")
    if not torch.is_tensor(diag_add) and diag_add < 0.0:
        raise ValueError(f"dense_gram_for: diag_add must be >= 0, got {diag_add}")
    route = _kernel_route(kernel, x1)
    if route is None:
        K = kernel.gram(x1, x2)
        return add_diag(K, diag_add) if add else K
    build, extra = route
    params = [kernel.lengthscale] + ([kernel.variance] if kernel.scaled else [])
    if torch.is_grad_enabled() and any(p.requires_grad for p in params):
        raise RuntimeError(
            f"dense_gram_for: {build.__name__} is forward-only (it has no "
            "VJP), and the kernel's hyperparameters require grad; build the "
            "Gram under torch.no_grad() or differentiate kernel.gram")
    ls = kernel.lengthscale.detach()
    if ls.ndim > 0:
        x1, x2, ls = x1 / ls, x2 / ls, 1.0
    var = kernel.variance.detach() if kernel.scaled else 1.0
    if torch.is_tensor(diag_add):
        diag_add = diag_add.detach()
    return build(x1, x2, ls, var, diag_add, **extra)


def noised_gram(kernel, x, noise, jitter: float):
    """The dense route's K(x, x) + (σ² + jitter)·I in one build, the jitter
    floored as :func:`..linalg.cholesky.effective_jitter` floors it: the
    floor's mean of diag(K) comes from ``kernel.diag(x)`` (O(n)), so the
    kernel adds the whole diagonal term in its one pass. The shift stays on
    the device."""
    if not isinstance(noise, (int, float)):  # a Python number stays one
        noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device)
    shift = effective_jitter_of_diag(kernel.diag(x), jitter) + noise
    return dense_gram_for(kernel, x, x, shift)
