"""Engine configuration for the PyTorch port.

Counterpart of ``gaussianprocessfundamentals_tpu/config.py:39``
(``GPConfig``), with the fields the posterior and fitting paths read: the
diagonal jitter, the change-point gate, the Nyström inducing ratio, the
float32 matmul precision, the jitter escalations of ``fit`` and the dense
working-set budget that routes large fits to the matrix-free iterative
route. ``ChangePointGate`` is the JAX package's enum (``config.py:25-35``),
with the same value strings, so kernel and mean ASTs interchange;
:func:`default_dtype` is ``config.py:71``'s.
"""
from __future__ import annotations

import dataclasses
import enum

import torch


class ChangePointGate(enum.Enum):
    """Gate of the change-point operators: INDICATOR = hard ``x < cp``,
    SIGMOID = tanh ramp, APPROX_INDICATOR = steep logistic."""

    INDICATOR = "indicator"
    SIGMOID = "sigmoid"
    APPROX_INDICATOR = "approx_indicator"


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Immutable engine configuration."""

    # jitter added to every covariance diagonal (reference default 1e-8)
    jitter: float = 1e-8
    # gate of ChangePoint and MeanChangePoint when none is given
    cp_gate: ChangePointGate = ChangePointGate.INDICATOR
    # inducing inputs per training row of fit(approximation=...) when
    # n_inducing is not given: m = max(20, ⌊ratio·n⌋) (reference 0.1)
    nystroem_ratio: float = 0.1
    # float32 matmul precision the CUDA path requires: "highest" is full
    # float32. One TF32 pass keeps about three decimal digits, which breaks
    # CG residuals and Cholesky-grade posteriors. (The Gram·V kernels K1 and
    # K3 use the tensor cores inside, in 3xTF32, which keeps float32's
    # digits; torch's own matmuls stay at this precision.)
    matmul_precision: str = "highest"
    # ×10 jitter escalations fit() tries when the dense NLL comes out
    # non-finite (a Cholesky that failed)
    max_jitter_retries: int = 6
    # bytes the dense NLL+grad working set (~3·n²·itemsize: K, its factor,
    # the VJP cotangent) may take before fit() must route to the iterative
    # route: half of one H100's 80 GB, as the JAX package took half of a
    # 16 GB v5e
    dense_hbm_budget: float = 40e9


DEFAULT_CONFIG = GPConfig()


def default_dtype() -> torch.dtype:
    """The dtype new tensors take: ``torch.get_default_dtype()`` (the JAX
    package's float64-when-x64-is-enabled)."""
    return torch.get_default_dtype()
