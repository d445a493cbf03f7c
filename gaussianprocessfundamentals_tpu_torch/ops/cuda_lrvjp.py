"""The fused low-rank-cotangent gradient (K2) and the routers that hand it to
the iterative NLL.

Counterpart of ``gaussianprocessfundamentals_tpu/ops/pallas_gram.py``:
``fused_lowrank_vjp_cross`` (``:398``), ``fused_lowrank_vjp`` (``:469``),
``fused_lowrank_vjp_for`` (``:510``) and ``fused_lowrank_vjp_cross_for``
(``:560``). The TPU kernel becomes the hand-written CUDA kernel in
``csrc/lowrank_vjp.cu`` (sm_90a, bound with ctypes) on the tile loop of
``csrc/lowrank_mma.cuh``, which it shares with K4; the header's note says
what bounds it and how it is laid out.

Routing is by the device of the tensors, as for K1 (:mod:`.cuda_gram`):

* CPU tensors take the plain streamed autograd version
  (:func:`..ops.gram_matvec.lowrank_gram_vjp_cross`);
* CUDA tensors launch the kernel for the leaves it covers (scalar-
  lengthscale SE at any d, Matérn at d = 1, as ``pallas_gram.py:484-507``
  does); the router hands the expressions the generated code covers --
  ARD lengthscales, Matérn at d > 1, the other leaves and composites --
  to the composite-expression kernel K4 (:mod:`.cuda_expr`), as
  ``pallas_gram.py:516-522`` does, and every other covariance
  (ChangePoint, Partition, other than SE at d > 8, WhiteNoise below the
  root Sum) to the plain streamed version, as the JAX package does
  (``models/iterative.py:54-61`` there). A covariance with malformed
  parameters is refused by name. :func:`vjp_route` decides.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from gaussianprocessfundamentals_tpu_torch.kernels.leaves import (
    Matern32Kernel,
    Matern52Kernel,
    SquaredExponentialKernel,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
    _KINDS,
    _LEAF,
    _MAX_D,
    _pad_cols,
    _padded_width,
    _route,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_expr import (
    expr_lowrank_vjp_cross_for,
)
from gaussianprocessfundamentals_tpu_torch.ops.gram_matvec import (
    lowrank_gram_vjp_cross,
)

_K4_ROUTE = (
    "K2 covers SE and Matérn at d = 1; route other kernels through "
    "fused_lowrank_vjp_cross_for, which hands them to K4 "
    "(ops.cuda_expr.expr_lowrank_vjp_cross)"
)


@functools.lru_cache(maxsize=None)
def _lib():
    """(entry point, tile edge) of the built library."""
    from gaussianprocessfundamentals_tpu_torch.ops import cuda_build

    lib = cuda_build.load("lowrank_vjp.cu")
    fn = lib.gpf_lowrank_vjp
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    tile = lib.gpf_lowrank_vjp_tile
    tile.argtypes = []
    tile.restype = ctypes.c_int
    return fn, tile()


def plain_lowrank_vjp_cross(x1, x2, U, W, lengthscale, variance=1.0,
                            kind: str = "se"):
    """K2 in plain PyTorch: (∂/∂ℓ, ∂/∂var) of Σ(UWᵀ)∘K(x1, x2) for the
    kind's leaf scaled by ``variance``, by autograd over row panels."""
    kernel = _LEAF[kind](dim=x1.shape[-1], scaled=True).set_params({
        "lengthscale": torch.as_tensor(lengthscale, dtype=x1.dtype,
                                       device=x1.device),
        "variance": torch.as_tensor(variance, dtype=x1.dtype,
                                    device=x1.device),
    })
    g = lowrank_gram_vjp_cross(kernel, x1, x2, U, W)
    return g["lengthscale"], g["variance"]


def fused_lowrank_vjp_cross(x1, x2, U, W, lengthscale, variance=1.0,
                            kind: str = "se"):
    """(g_lengthscale, g_variance) of Σᵢⱼ (UWᵀ)ᵢⱼ K(x1, x2)ᵢⱼ in one pass,
    with analytic in-tile derivatives; K and UWᵀ never reach memory.

    x1: [n1, d], x2: [n2, d], U: [n1, r], W: [n2, r], all float32; returns
    two float32 scalars. ``g_variance`` is Σ cot·K/var, valid whether or
    not the kernel carries a variance (callers of unscaled kernels drop
    it). ``kind`` ∈ {"se", "mat32", "mat52"}; SE takes any d, Matérn
    needs d = 1.
    ``lengthscale`` and ``variance`` are scalars; pass Python floats on the
    hot path (a CUDA tensor costs a device-to-host read per call).

    CPU tensors take :func:`plain_lowrank_vjp_cross`; CUDA tensors launch
    the kernel on the current stream and add one to
    ``fused_lowrank_vjp_cross.launches``.
    """
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {sorted(_KINDS)}, got {kind!r}")
    tensors = (x1, x2, U, W)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return plain_lowrank_vjp_cross(x1, x2, U, W, lengthscale, variance,
                                       kind)
    if len(devices) != 1 or x1.device.type != "cuda":
        raise ValueError(
            f"fused_lowrank_vjp_cross: tensors on {sorted(map(str, devices))}; "
            "need all on the CPU or all on one CUDA device"
        )
    if any(t.requires_grad for t in tensors) or any(
        torch.is_tensor(p) and p.requires_grad for p in (lengthscale, variance)
    ):
        raise RuntimeError(
            "fused_lowrank_vjp_cross computes its gradient analytically: its "
            "inputs must not require grad"
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            "fused_lowrank_vjp_cross takes float32 tensors, got "
            f"{[str(t.dtype) for t in tensors]}"
        )
    if x1.ndim != 2 or x2.ndim != 2 or U.ndim != 2 or W.ndim != 2:
        raise ValueError("x1, x2 must be [n, d] and U, W [n, r]")
    n1, d = x1.shape
    n2, r = W.shape
    if x2.shape[1] != d or U.shape != (n1, r):
        raise ValueError(
            f"shape mismatch: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, "
            f"U {tuple(U.shape)}, W {tuple(W.shape)}"
        )
    if kind != "se" and d != 1:
        raise NotImplementedError(f"Matérn at d={d} > 1: {_K4_ROUTE}")
    ls = float(lengthscale)
    var = float(variance)
    zero = torch.zeros((), dtype=torch.float32, device=x1.device)
    if n1 == 0 or n2 == 0 or r == 0:
        return zero, zero.clone()
    if kind == "se":
        a, b = -0.5 / (ls * ls), 1.0 / (ls * ls * ls)
    else:
        a = (math.sqrt(3.0) if kind == "mat32" else math.sqrt(5.0)) / ls
        b = 1.0 / ls

    # above 8 dimensions the kernel takes x at its own width (run time)
    width = _padded_width(d) if d <= _MAX_D else d
    x1c = _pad_cols(x1, width)
    x2c = _pad_cols(x2, width)
    Uc, Wc = U.contiguous(), W.contiguous()
    fn, tile = _lib()
    blocks = -(-n1 // tile) * -(-n2 // tile)
    partial = torch.empty((blocks, 2), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x1c.data_ptr(), x2c.data_ptr(), Uc.data_ptr(), Wc.data_ptr(),
                 partial.data_ptr(), n1, n2, width, r, _KINDS[kind], a, b,
                 stream)
    if err != 0:
        raise RuntimeError(f"gpf_lowrank_vjp launch failed: cudaError {err}")
    fused_lowrank_vjp_cross.launches += 1
    # per-tile partials summed in float64 on the device: no float32 chain
    # across tiles
    g = partial.double().sum(dim=0)
    return (var * g[0]).float(), g[1].float()


fused_lowrank_vjp_cross.launches = 0


def fused_lowrank_vjp(x, U, W, lengthscale, variance=1.0, kind: str = "se"):
    """Square (x1 = x2 = x) form of :func:`fused_lowrank_vjp_cross`."""
    return fused_lowrank_vjp_cross(x, x, U, W, lengthscale, variance, kind)


def _k2_kind(kernel, d: int):
    """K2's ``kind`` for a leaf it covers, else None (pallas_gram.py:484):
    SE at any d and Matérn-3/2 / -5/2 at d = 1, with a scalar lengthscale.
    ARD lengthscales are K4's, in the JAX package too."""
    ls = getattr(kernel, "lengthscale", None)
    if ls is None or ls.ndim != 0:
        return None
    if type(kernel) is SquaredExponentialKernel:
        return "se"
    if d != 1:
        return None
    if type(kernel) is Matern32Kernel:
        return "mat32"
    if type(kernel) is Matern52Kernel:
        return "mat52"
    return None


def vjp_route(kernel, d: int) -> str:
    """Which version computes the gradient of Σ(UWᵀ)∘K(x1, x2) on a card:
    "K2", "K4" or "plain" (the streamed autograd version, as on the CPU)."""
    return _route(_k2_kind(kernel, d) is not None, kernel, d, "K2", "K4")


def fused_lowrank_vjp_cross_for(kernel, x1, x2, block: int = 2048):
    """A ``(U, W) -> grads`` closure for the device of x1, giving the
    gradient of Σ(UWᵀ)∘K(x1, x2) with respect to the kernel's
    hyperparameters as a tree shaped like its params: the plain streamed
    autograd version on the CPU; on a card the version :func:`vjp_route`
    picks: K2 for the leaves it covers, K4
    (:func:`.cuda_expr.expr_lowrank_vjp_cross_for`) for the expressions its
    generated code covers, the plain version for every other covariance.

    K2's hyperparameters are read to the host once here, not per call.
    ``block`` is the plain version's panel height.
    """
    if x1.device.type == "cpu":
        route = "plain"
    elif x1.device.type == "cuda":
        route = vjp_route(kernel, x1.shape[-1])
    else:
        raise NotImplementedError(f"no low-rank VJP route for device {x1.device}")
    if route == "plain":
        return lambda U, W: lowrank_gram_vjp_cross(kernel, x1, x2, U, W, block)
    if route == "K4":
        return expr_lowrank_vjp_cross_for(kernel, x1, x2)
    kind = _k2_kind(kernel, x1.shape[-1])
    dtype = kernel.lengthscale.dtype
    ls = float(kernel.lengthscale.detach())
    var = float(kernel.variance.detach()) if kernel.scaled else 1.0

    def vjp(U, W):
        g_ls, g_var = fused_lowrank_vjp_cross(x1, x2, U, W, ls, var, kind)
        out = {"lengthscale": g_ls.to(dtype)}
        if kernel.scaled:
            out["variance"] = g_var.to(dtype)
        return out

    return vjp


def fused_lowrank_vjp_for(kernel, x):
    """Square form of :func:`fused_lowrank_vjp_cross_for`."""
    return fused_lowrank_vjp_cross_for(kernel, x, x)
