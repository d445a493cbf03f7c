"""The fused Gram·V kernel (K1) and the routers that hand it to the solvers.

Counterpart of ``gaussianprocessfundamentals_tpu/ops/pallas_gram.py``:
``fused_gram_matvec_cross`` (``:252``), ``fused_gram_matvec`` (``:322``),
``fused_matvec_cross_for`` (``:540``) and ``fused_matvec_for`` (``:592``).
The TPU kernel becomes the hand-written CUDA kernel in
``csrc/gram_matvec.cu`` (sm_90a, bound with ctypes); its source note says
what bounds it and how it is laid out.

Routing is by the device of the tensors, never by a setting:

* CPU tensors take the plain row-panel version (:mod:`.gram_matvec`);
* CUDA tensors launch the kernel for the leaves it covers (SE at d <= 8,
  Matérn at d = 1, scalar lengthscale or ARD SE by scaling x); the router
  hands the expressions the generated code covers to the composite-
  expression kernel K3 (:mod:`.cuda_expr`), as ``pallas_gram.py:546-553,
  603-609`` do, and every other covariance (ChangePoint, Partition, d > 8,
  WhiteNoise below the root Sum) to the plain row-panel version, which is
  the JAX package's own default for every covariance
  (``ops/gram_matvec.py:36-74`` there; its fused tiles only on request).
  A covariance with malformed parameters is refused by name.
  :func:`gram_route` decides.

Forward-only, as the TPU kernel was: the iterative path never
differentiates through a CG matvec, so the wrapper refuses inputs that
require grad.
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
from gaussianprocessfundamentals_tpu_torch.ops.cuda_expr import (
    expr_matvec_cross_for,
)
from gaussianprocessfundamentals_tpu_torch.ops.expr import (
    malformed,
    split_white_noise,
    uncovered,
)
from gaussianprocessfundamentals_tpu_torch.ops.gram_matvec import (
    streamed_gram_matvec_cross,
)

_KINDS = {"se": 0, "mat32": 1, "mat52": 2}
_LEAF = {"se": SquaredExponentialKernel, "mat32": Matern32Kernel,
         "mat52": Matern52Kernel}
# The kernel keeps one x row per thread in registers at a padded width:
# SE at d <= 8 (pad columns are zero in both x1 and x2, so distances are
# unchanged), Matérn at d = 1.
_MAX_D = 8

_K3_ROUTE = (
    "K1 covers SE and Matérn at d = 1; route other kernels through "
    "fused_matvec_cross_for, which hands them to K3 "
    "(ops.cuda_expr.expr_gram_matvec_cross)"
)


@functools.lru_cache(maxsize=None)
def _lib():
    from gaussianprocessfundamentals_tpu_torch.ops import cuda_build

    lib = cuda_build.load("gram_matvec.cu")
    fn = lib.gpf_gram_matvec
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    return fn


def plain_gram_matvec_cross(x1, x2, V, lengthscale, variance=1.0,
                            kind: str = "se", block: int = 2048):
    """K1 in plain PyTorch: row panels of the kind's leaf covariance
    (scaled by ``variance``) times V."""
    kernel = _LEAF[kind](dim=x1.shape[-1], scaled=True).set_params({
        "lengthscale": torch.as_tensor(lengthscale),
        "variance": torch.as_tensor(variance),
    }).to(x1)
    return streamed_gram_matvec_cross(kernel, x1, x2, V, block)


def _padded_width(d: int) -> int:
    return 1 if d == 1 else 4 if d <= 4 else 8


def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    if x.shape[1] == width:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, width - x.shape[1])).contiguous()


def fused_gram_matvec_cross(x1, x2, V, lengthscale, variance=1.0,
                            kind: str = "se"):
    """K(x1, x2) @ V with K tiles kept in registers (never in memory).

    x1: [n1, d], x2: [n2, d], V: [n2, r] or [n2], all float32 → [n1, r]
    (or [n1]). ``kind`` ∈ {"se", "mat32", "mat52"}; Matérn needs d = 1.
    ``lengthscale`` and ``variance`` are scalars; pass Python floats on the
    hot path (a CUDA tensor costs a device-to-host read per call).

    CPU tensors take :func:`plain_gram_matvec_cross`; CUDA tensors launch
    the kernel on the current stream and add one to
    ``fused_gram_matvec_cross.launches``.
    """
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {sorted(_KINDS)}, got {kind!r}")
    tensors = (x1, x2, V)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return plain_gram_matvec_cross(x1, x2, V, lengthscale, variance, kind)
    if len(devices) != 1 or x1.device.type != "cuda":
        raise ValueError(
            f"fused_gram_matvec_cross: tensors on {sorted(map(str, devices))}; "
            "need all on the CPU or all on one CUDA device"
        )
    if any(t.requires_grad for t in tensors) or any(
        torch.is_tensor(p) and p.requires_grad for p in (lengthscale, variance)
    ):
        raise RuntimeError(
            "fused_gram_matvec_cross is forward-only: its inputs must not "
            "require grad"
        )
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            "fused_gram_matvec_cross takes float32 tensors, got "
            f"{[str(t.dtype) for t in tensors]}"
        )
    if x1.ndim != 2 or x2.ndim != 2 or V.ndim not in (1, 2):
        raise ValueError("x1, x2 must be [n, d] and V [n2, r] or [n2]")
    n1, d = x1.shape
    n2 = x2.shape[0]
    if x2.shape[1] != d or V.shape[0] != n2:
        raise ValueError(
            f"shape mismatch: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, "
            f"V {tuple(V.shape)}"
        )
    if kind != "se" and d != 1:
        raise NotImplementedError(f"Matérn at d={d} > 1: {_K3_ROUTE}")
    if d > _MAX_D:
        raise NotImplementedError(
            f"the CUDA Gram·V kernel covers d <= {_MAX_D}, got d={d}"
        )
    ls = float(lengthscale)
    var = float(variance)
    a = -0.5 / (ls * ls) if kind == "se" else (
        math.sqrt(3.0) if kind == "mat32" else math.sqrt(5.0)) / ls

    width = _padded_width(d)
    x1c = _pad_cols(x1, width)
    x2c = _pad_cols(x2, width)
    vec = V.ndim == 1
    Vc = (V[:, None] if vec else V).contiguous()
    r = Vc.shape[1]
    out = torch.empty((n1, r), dtype=torch.float32, device=x1.device)
    fn = _lib()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x1c.data_ptr(), x2c.data_ptr(), Vc.data_ptr(),
                 out.data_ptr(), n1, n2, width, r, _KINDS[kind], a, var,
                 stream)
    if err != 0:
        raise RuntimeError(f"gpf_gram_matvec launch failed: cudaError {err}")
    fused_gram_matvec_cross.launches += 1
    return out[:, 0] if vec else out


fused_gram_matvec_cross.launches = 0


def fused_gram_matvec(x, V, lengthscale, variance=1.0, kind: str = "se"):
    """K(x, x) @ V: square form of :func:`fused_gram_matvec_cross`."""
    return fused_gram_matvec_cross(x, x, V, lengthscale, variance, kind)


def _k1_kind(kernel, d: int):
    """K1's ``kind`` for a leaf it covers, else None (pallas_gram.py:484):
    SE at any lengthscale shape, Matérn-3/2 / -5/2 at d = 1 with a scalar
    lengthscale."""
    if type(kernel) is SquaredExponentialKernel:
        return "se"
    ls = getattr(kernel, "lengthscale", None)
    if ls is None or ls.ndim != 0 or d != 1:
        return None
    if type(kernel) is Matern32Kernel:
        return "mat32"
    if type(kernel) is Matern52Kernel:
        return "mat52"
    return None


def _route(leaf_covers: bool, kernel, d: int, leaf: str, expr: str) -> str:
    """``leaf`` where the leaf kernel covers the covariance, ``expr`` where
    the generated expression code covers it once WhiteNoise is stripped
    from the root Sum (a bare WhiteNoise root included), else "plain".
    Raises NotImplementedError, naming the fault, for malformed parameters
    (:func:`..ops.expr.malformed`), which no route computes."""
    if leaf_covers:
        return leaf
    core, _ = split_white_noise(kernel)
    if core is None:
        return expr
    why = malformed(core, d)
    if why is not None:
        raise NotImplementedError(
            f"{kernel.canonical_str()} at d={d}: no CUDA route takes it: {why}")
    return expr if uncovered(core, d) is None else "plain"


def gram_route(kernel, d: int) -> str:
    """Which version computes K(x1, x2)·V on a card: "K1", "K3" or "plain"
    (the row-panel version, as on the CPU)."""
    return _route(_k1_kind(kernel, d) is not None and d <= _MAX_D, kernel, d,
                  "K1", "K3")


def fused_matvec_cross_for(kernel, x1, x2, block: int = 2048):
    """A ``V -> K(x1, x2) @ V`` closure for the device of x1: the plain
    row-panel version on the CPU; on a card the version
    :func:`gram_route` picks: K1 for the leaves it covers, K3
    (:func:`.cuda_expr.expr_matvec_cross_for`) for the expressions its
    generated code covers, the plain version for every other covariance.
    ``block`` is the plain version's panel height.

    K1's hyperparameters are read to the host once here, not per call.
    ARD SE is covered by scaling x by 1/ℓ first, as ``gram`` does.
    """
    if x1.device.type == "cpu":
        route = "plain"
    elif x1.device.type == "cuda":
        route = gram_route(kernel, x1.shape[-1])
    else:
        raise NotImplementedError(f"no Gram·V route for device {x1.device}")
    if route == "plain":
        return lambda V: streamed_gram_matvec_cross(kernel, x1, x2, V, block)
    if route == "K3":
        return expr_matvec_cross_for(kernel, x1, x2)
    kind = _k1_kind(kernel, x1.shape[-1])
    ls = kernel.lengthscale.detach()
    if ls.ndim > 0:
        x1, x2, ls_f = x1 / ls, x2 / ls, 1.0
    else:
        ls_f = float(ls)
    var = float(kernel.variance.detach()) if kernel.scaled else 1.0
    return lambda V: fused_gram_matvec_cross(x1, x2, V, ls_f, var, kind)


def fused_matvec_for(kernel, x):
    """``V -> K(x, x) @ V``: square form of :func:`fused_matvec_cross_for`."""
    return fused_matvec_cross_for(kernel, x, x)
