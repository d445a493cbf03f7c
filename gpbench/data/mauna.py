"""n evenly spaced times over [t0, t1] years, a Mauna-Loa-shaped CO2
series (trend and two seasonal harmonics) plus sd·ε, x and y min-max
normalised to [0, 1] (d = 1)."""
import math

import torch


def series(t):
    return (315.0 + 0.8 * (t - 1958.0) + 0.012 * (t - 1958.0) ** 2
            + 3.0 * torch.sin(2 * math.pi * t) + 0.8 * torch.sin(4 * math.pi * t))


def make(cfg, g, device):
    n, data = cfg["n"], cfg["data"]
    t = torch.linspace(data["t0"], data["t1"], n, dtype=torch.float64,
                       device=device)
    y = series(t) + data["noise_sd"] * torch.randn(
        n, generator=g, device=device, dtype=torch.float64)
    x = (t - t.min()) / (t.max() - t.min())
    y = (y - y.min()) / (y.max() - y.min())
    return x[:, None].float(), y.float()
