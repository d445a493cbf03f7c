"""The 3xTF32 arithmetic of the Gram·V kernels K1 and K3
(``csrc/gram_mma.cuh``), emulated on the CPU.

The kernels split each operand a into TF32 halves, ``hi = cvt.rna.tf32.f32
(a)`` and ``lo = cvt.rna.tf32.f32(a - hi)``, and per tile of x2 rows add
``k_lo·v_hi + k_hi·v_lo`` and then ``k_hi·v_hi`` into a float32 partial
that is added to the running total. Here ``cvt.rna`` is emulated on the
int32 view (round to nearest, ties away from zero, 10 mantissa bits kept),
and the same tiled three-term product of an SE Gram row panel and V is
held against float64 within ``K3_RTOL``·max|ref|, the limit the card checks
K1 and K3 with (``chip_smoke.py``); one TF32 pass misses it.
"""
import numpy as np
import pytest
import torch

K3_RTOL = 5e-5  # chip_smoke.K3_RTOL: the JAX gates expr_matvec_*


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: the 13 low mantissa bits rounded off, ties
    away from zero (adding half an ulp to the magnitude bits of a
    sign-magnitude number rounds it away from zero on a tie)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def tiled_product(K, V, bn: int, passes: int):
    """K @ V over x2 tiles of ``bn`` rows as the kernels run it: per tile a
    float32 partial (3xTF32: small terms first; 1: ``k_hi·v_hi`` alone),
    added to a float32 running total."""
    total = torch.zeros(K.shape[0], V.shape[1], dtype=torch.float32)
    for j in range(0, K.shape[1], bn):
        kh, kl = split(K[:, j:j + bn])
        vh, vl = split(V[j:j + bn])
        if passes == 3:
            part = kl @ vh
            part = part + kh @ vl
            part = part + kh @ vh
        else:
            part = kh @ vh
        total = total + part
    return total


def _panel(r: int):
    """An SE Gram row panel K(x1, x2) [256, 8192] in float32 (ℓ = 0.1, x2
    sorted U(0, 1), x1 every 32nd x2 row, so each row's terms span the
    whole chain) and V ~ N(0, 1) [8192, r]."""
    rng = np.random.default_rng(5)
    x2 = np.sort(rng.uniform(0.0, 1.0, 8192)).astype(np.float32)
    V = rng.standard_normal((8192, r)).astype(np.float32)
    x2t = torch.from_numpy(x2)
    d = x2t[::32, None] - x2t[None, :]
    K = torch.exp(-0.5 * d * d / np.float32(0.01))
    return K, torch.from_numpy(V)


def test_rna_rounds_ties_away_from_zero_and_keeps_ten_bits():
    one = torch.tensor([1.0, -1.0])
    tie = one * (1 + 2.0 ** -11)  # halfway between 1 and 1 + 2^-10
    assert torch.equal(tf32_rna(tie), one * (1 + 2.0 ** -10))
    below = one * (1 + 2.0 ** -11 - 2.0 ** -23)
    assert torch.equal(tf32_rna(below), one)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000)
                         .astype(np.float32))
    hi, lo = split(x)
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((lo.view(torch.int32) & 0x1FFF) == 0)
    assert float(((x - hi) / x).abs().max()) <= 2.0 ** -11
    assert float(((x.double() - hi.double() - lo.double()) / x.double())
                 .abs().max()) <= 2.0 ** -21


# r and the x2 tile the kernel uses at that width (csrc/gram_mma.cuh:
# 64 rows at r <= 16, 32 above)
@pytest.mark.parametrize("r,bn", [(9, 64), (256, 32)])
def test_three_tf32_passes_hold_float64_within_k3_rtol(r, bn):
    K, V = _panel(r)
    ref = K.double() @ V.double()
    got = tiled_product(K, V, bn, passes=3)
    err = float((got.double() - ref).abs().max())
    assert err <= K3_RTOL * float(ref.abs().max())


@pytest.mark.parametrize("r,bn", [(9, 64), (256, 32)])
def test_one_tf32_pass_misses_k3_rtol(r, bn):
    K, V = _panel(r)
    ref = K.double() @ V.double()
    got = tiled_product(K, V, bn, passes=1)
    err = float((got.double() - ref).abs().max())
    assert err > K3_RTOL * float(ref.abs().max())
