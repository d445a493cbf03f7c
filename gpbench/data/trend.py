"""Sorted x ~ U(0, 1), y = 2 + 3x + sin(8x) + sd·ε (d = 1)."""
import torch


def make(cfg, g, device):
    n, sd = cfg["n"], cfg["data"]["noise_sd"]
    x = torch.sort(torch.rand(n, 1, generator=g, device=device), dim=0).values
    y = (2.0 + 3.0 * x[:, 0] + torch.sin(8.0 * x[:, 0])
         + sd * torch.randn(n, generator=g, device=device))
    return x, y
