"""Posterior and prior plots (numpy and matplotlib).

Counterpart of ``gaussianprocessfundamentals_tpu/viz/plots.py``:
``plot_posterior`` draws the posterior mean with a ±2σ band, the train and
test points and change-point lines, ``plot_prior_samples`` a few prior
draws; either saves to ``path`` (SVG by its suffix) or returns the figure.
Tensors are accepted on any device. Matplotlib is imported on the first
plot, so importing the port does not need it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def plot_posterior(
    x_test, mean, sd,
    x_train=None, y_train=None, y_test=None,
    changepoints: Optional[Sequence[float]] = None,
    path: Optional[str] = None,
    title: str = "GP posterior",
):
    plt = _plt()
    x_test = _np(x_test).reshape(-1)
    order = np.argsort(x_test)
    xt, mu, s = x_test[order], _np(mean)[order], _np(sd)[order]
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.fill_between(xt, mu - 2 * s, mu + 2 * s, alpha=0.25, label="±2σ")
    ax.plot(xt, mu, lw=1.5, label="posterior mean")
    if x_train is not None:
        ax.scatter(_np(x_train).reshape(-1), _np(y_train), s=6, alpha=0.5,
                   label="train")
    if y_test is not None:
        ax.scatter(xt, _np(y_test)[order], s=6, alpha=0.5, marker="x",
                   label="test")
    for cp in changepoints or []:
        ax.axvline(float(cp), ls="--", lw=0.8, color="grey")
    ax.set_title(title)
    ax.legend()
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_prior_samples(x, samples, path: Optional[str] = None,
                       title: str = "GP prior samples"):
    plt = _plt()
    x = _np(x).reshape(-1)
    order = np.argsort(x)
    fig, ax = plt.subplots(figsize=(10, 5))
    for s in np.atleast_2d(_np(samples)):
        ax.plot(x[order], s[order], lw=1.0, alpha=0.8)
    ax.set_title(title)
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig
