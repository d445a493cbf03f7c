"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W).

A float32-accurate product on the tensor cores takes three TF32 products
(hi·hi + hi·lo + lo·hi), so no float32-accurate product runs faster than
the TF32 peak over three. Kernel evaluations run on the float32 pipes (a
transcendental counted as one operation: it can run on the FMA pipes as a
polynomial, so no special-function ceiling bounds every implementation).
"""
TF32_FLOPS = 495e12
F32_ACCURATE_PRODUCT_FLOPS = TF32_FLOPS / 3.0  # 165 TFLOP/s
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
