"""Engine configuration for the PyTorch port.

Counterpart of ``gaussianprocessfundamentals_tpu/config.py:39``
(``GPConfig``). This slice serves posteriors, so it carries only what the
posterior path reads: the diagonal jitter and the float32 matmul precision.
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


DEFAULT_CONFIG = GPConfig()
