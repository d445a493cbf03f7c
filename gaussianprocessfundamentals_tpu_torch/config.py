"""Engine configuration for the PyTorch port.

Counterpart of ``gaussianprocessfundamentals_tpu/config.py:39``
(``GPConfig``), with the fields the posterior and fitting paths read: the
diagonal jitter, the float32 matmul precision, the jitter escalations of
``fit`` and the dense working-set budget that routes large fits to the
matrix-free iterative route.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Immutable engine configuration."""

    # jitter added to every covariance diagonal (reference default 1e-8)
    jitter: float = 1e-8
    # float32 matmul precision the CUDA path requires: "highest" is full
    # float32. TF32 keeps about three decimal digits, which breaks CG
    # residuals and Cholesky-grade posteriors.
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
