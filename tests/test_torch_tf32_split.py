"""The 3xTF32 arithmetic of the Gram·V kernels K1 and K3
(``csrc/gram_mma.cuh``) and of the low-rank-VJP kernels K2 and K4
(``csrc/lowrank_mma.cuh``), emulated on the CPU.

The kernels split each operand a into TF32 halves, ``hi = cvt.rna.tf32.f32
(a)`` and ``lo = cvt.rna.tf32.f32(a - hi)``, and per tile of x2 rows add
``k_lo·v_hi + k_hi·v_lo`` and then ``k_hi·v_hi`` into a float32 partial
that is added to the running total. Here ``cvt.rna`` is emulated on the
int32 view (round to nearest, ties away from zero, 10 mantissa bits kept),
and the same tiled three-term product of an SE Gram row panel and V is
held against float64 within ``K3_RTOL``·max|ref|, the limit the card checks
K1 and K3 with (``chip_smoke.py``); one TF32 pass misses it.

K2 and K4 make the cotangent tile U Wᵀ the same way, with U's and W's
r columns as the reduction axis: per 8-wide k-step ``u_lo·w_hi``, then
``u_hi·w_lo``, then ``u_hi·w_hi`` into a float32 partial that starts at
zero and is added to the float32 accumulator. That tile, emulated at
n = 1,024 and r = 273 on a zero-mean cotangent (whose sums cancel, as the
fit's do) and fed to SE's epilogue (float32 kernel values, their sums in
float64), holds g_k and g_dk within ``K2_RTOL_CANCEL`` of float64, the
limit the card checks K2 with; one TF32 pass misses it.
"""
import numpy as np
import pytest
import torch

K3_RTOL = 5e-5  # chip_smoke.K3_RTOL: the JAX gates expr_matvec_*
K2_RTOL_CANCEL = 1e-4  # chip_smoke.K2_RTOL_CANCEL


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


def cotangent_tile(U, W, passes: int):
    """U Wᵀ as K2 and K4 make it: per 8-wide k-step of r (zero-padded), a
    float32 partial of 3xTF32 (``u_lo·w_hi``, ``u_hi·w_lo``, then
    ``u_hi·w_hi``) or one pass (``u_hi·w_hi``), added to a float32
    accumulator."""
    r = U.shape[1]
    pad = -r % 8
    U = torch.nn.functional.pad(U, (0, pad))
    W = torch.nn.functional.pad(W, (0, pad))
    acc = torch.zeros(U.shape[0], W.shape[0], dtype=torch.float32)
    for k in range(0, r + pad, 8):
        uh, ul = split(U[:, k:k + 8])
        wh, wl = split(W[:, k:k + 8])
        if passes == 3:
            part = ul @ wh.T
            part = part + uh @ wl.T
            part = part + uh @ wh.T
        else:
            part = uh @ wh.T
        acc = acc + part
    return acc


def _se_epilogue(cot, x, ls: float, dtype):
    """(g_k, g_dk) of SE at lengthscale ``ls``: the kernel value and its ℓ
    derivative in ``dtype``, their products with the cotangent summed in
    float64."""
    d = (x[:, None] - x[None, :]).to(dtype)
    d2 = d * d
    k = torch.exp(-0.5 * d2 / ls ** 2)
    dk = k * d2 / ls ** 3
    return [float((cot.double() * f.double()).sum()) for f in (k, dk)]


def _vjp_case():
    """Sorted x ~ U(0, 1) (n = 1,024), a zero-mean cotangent U, W ~ N(0, 1)
    at r = 2·8 + 256 + 1 = 273, the float64 reference (g_k, g_dk)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(np.sort(rng.uniform(0.0, 1.0, 1024)))
    U = torch.from_numpy(rng.standard_normal((1024, 273)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((1024, 273)).astype(np.float32))
    ref = _se_epilogue(U.double() @ W.double().T, x, 0.1, torch.float64)
    return x, U, W, ref


def test_three_tf32_cotangent_tile_holds_float64_within_k2_rtol_cancel():
    x, U, W, ref = _vjp_case()
    got = _se_epilogue(cotangent_tile(U, W, passes=3), x.float(), 0.1,
                       torch.float32)
    for a, b in zip(got, ref):
        assert abs(a - b) <= K2_RTOL_CANCEL * abs(b), (a, b)


def test_one_tf32_pass_cotangent_tile_misses_k2_rtol_cancel():
    x, U, W, ref = _vjp_case()
    got = _se_epilogue(cotangent_tile(U, W, passes=1), x.float(), 0.1,
                       torch.float32)
    assert max(abs(a - b) / abs(b) for a, b in zip(got, ref)) > K2_RTOL_CANCEL
