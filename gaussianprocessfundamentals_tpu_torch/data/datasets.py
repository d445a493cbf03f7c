"""Data plumbing: splits, normalisation, subsets, CSV loaders, synthetic
data.

Counterpart of ``gaussianprocessfundamentals_tpu/data/datasets.py``:
``MinMaxNormalization`` (``:24``), ``DataInput`` (``:46``),
``BatchDataInput`` (``:199``), ``load_csv`` / ``load_named``
(``:261-287``) and the ``synth_*`` generators (``:290-363``, numpy, the
same draws bit for bit). x is [n, d] and y [n]. The containers hold
tensors: built from numpy arrays they go to ``device`` (the GPU unless
the caller asks for another). Where the JAX package draws a split or a
random subset from ``jr.permutation(PRNGKey(seed))``, the port takes the
permutation itself or a ``torch.Generator`` to draw one from (``perm``);
without one it draws from a CPU generator seeded with 0, another fixed
permutation than the JAX package's seed 0. CSVs are read with the
standard library (no pandas).
"""
from __future__ import annotations

import copy
import csv
import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MinMaxNormalization:
    """Min-max scaling with its inverse (numpy arrays)."""

    lo: np.ndarray
    hi: np.ndarray

    @classmethod
    def fit(cls, v: np.ndarray) -> "MinMaxNormalization":
        v = np.asarray(v)
        return cls(lo=v.min(axis=0), hi=v.max(axis=0))

    def normalize(self, v):
        span = np.where(self.hi > self.lo, self.hi - self.lo, 1.0)
        return (v - self.lo) / span

    def denormalize(self, v):
        span = np.where(self.hi > self.lo, self.hi - self.lo, 1.0)
        return v * span + self.lo


def permutation(n: int, perm=None) -> np.ndarray:
    """A permutation of range(n): ``perm`` itself, or drawn from ``perm``
    when it is a ``torch.Generator``, or from a CPU generator seeded with 0
    when it is None."""
    if perm is None:
        perm = torch.Generator().manual_seed(0)
    if isinstance(perm, torch.Generator):
        perm = torch.randperm(n, generator=perm, device=perm.device)
    if isinstance(perm, torch.Tensor):
        perm = perm.cpu().numpy()
    perm = np.asarray(perm)
    if sorted(perm.tolist()) != list(range(n)):
        raise ValueError(f"perm is not a permutation of range({n})")
    return perm


@dataclasses.dataclass
class DataInput:
    """Train/test container. ``from_arrays`` normalises x and y (min-max)
    and applies the shuffled split (test_ratio 0.2 by default; test = train
    when the ratio is 0)."""

    x_train: torch.Tensor
    y_train: torch.Tensor
    x_test: torch.Tensor
    y_test: torch.Tensor
    x_norm: Optional[MinMaxNormalization] = None
    y_norm: Optional[MinMaxNormalization] = None

    @classmethod
    def from_arrays(cls, x, y, test_ratio: float = 0.2, perm=None,
                    normalize_x: bool = True, normalize_y: bool = True,
                    dtype=None, device="cuda") -> "DataInput":
        """``dtype`` None keeps float64."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[0] != y.shape[0]:
            raise ValueError(f"x has {x.shape[0]} rows, y {y.shape[0]}")
        xn = yn = None
        if normalize_x:
            xn = MinMaxNormalization.fit(x)
            x = xn.normalize(x)
        if normalize_y:
            yn = MinMaxNormalization.fit(y)
            y = yn.normalize(y)
        n = x.shape[0]
        if test_ratio and test_ratio > 0:
            idx = permutation(n, perm)
            n_test = int(round(n * test_ratio))
            test_idx, train_idx = np.sort(idx[:n_test]), np.sort(idx[n_test:])
        else:
            train_idx = test_idx = np.arange(n)

        def mk(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return cls(mk(x[train_idx]), mk(y[train_idx]), mk(x[test_idx]),
                   mk(y[test_idx]), xn, yn)

    @property
    def n_train(self) -> int:
        return self.x_train.shape[0]

    def xrange(self) -> torch.Tensor:
        """Per-dimension (min, max) of x_train, [d, 2]."""
        return torch.stack([self.x_train.min(dim=0).values,
                            self.x_train.max(dim=0).values], dim=-1)

    def is_equidistant(self, tol: float = 1e-8) -> bool:
        """True when x_train[:, 0] is an equispaced grid (gates SKI grid
        reuse)."""
        x0 = self.x_train[:, 0].cpu().numpy()
        if x0.size < 3:
            return True
        d = np.diff(np.sort(x0))
        return bool(np.all(np.abs(d - d[0]) <= tol * max(1.0, abs(d[0]))))

    def n_inducing(self, ratio: float = 0.1) -> int:
        """max(20, ratio·n)."""
        return max(20, int(ratio * self.n_train))

    def rescale_kernel_params(self, kernel, params):
        """Fitted kernel params in the ORIGINAL x units, undoing this
        input's min-max normalisation; a no-op when x was not normalised."""
        if self.x_norm is None:
            return params
        span = np.where(self.x_norm.hi > self.x_norm.lo,
                        self.x_norm.hi - self.x_norm.lo, 1.0)
        return kernel.x_rescale(params, self.x_norm.lo, span)

    # --- subset-of-data ----------------------------------------------------
    def _rows(self, idx) -> "DataInput":
        idx = torch.as_tensor(idx, device=self.x_train.device)
        return dataclasses.replace(self, x_train=self.x_train[idx],
                                   y_train=self.y_train[idx])

    def subset_random(self, size: int, perm=None) -> "DataInput":
        """``size`` rows of a permutation (:func:`permutation` of ``perm``),
        in their original order."""
        return self._rows(np.sort(permutation(self.n_train, perm)[:size]))

    def subset_grid(self, size: int) -> "DataInput":
        return self._rows(_grid_idx(self.n_train, size))

    def subset_smoothed_grid(self, size: int, smoothing_kernel=None
                             ) -> "DataInput":
        """Grid subset with y Nadaraya-Watson-smoothed over the whole
        training set by normalised kernel weights. The default smoothing
        kernel is an SE with an ARD bandwidth of one grid spacing
        (span/size) in each input dimension, applied by rescaling x per
        dimension. A ``smoothing_kernel`` without installed parameters is
        used at its defaults (on a copy). The weighted sum runs as
        elementwise products, full precision whatever TF32 setting."""
        from gaussianprocessfundamentals_tpu_torch.kernels.leaves import (
            SquaredExponentialKernel,
        )

        x, y = self.x_train, self.y_train
        idx = torch.as_tensor(_grid_idx(self.n_train, size), device=x.device)
        xg = x[idx]
        xq, xt = xg, x
        if smoothing_kernel is None:
            span = x.max(dim=0).values - x.min(dim=0).values
            ls = torch.clamp_min(span / max(size, 1), 1e-12)  # [d]
            xq, xt = xg / ls, x / ls
            smoothing_kernel = SquaredExponentialKernel().set_params(
                {"lengthscale": torch.ones((), dtype=x.dtype,
                                           device=x.device)})
        elif not smoothing_kernel.has_params():
            defaults = smoothing_kernel.init_params(
                self.xrange().cpu().numpy(), self.n_train, dtype=x.dtype)
            smoothing_kernel = copy.deepcopy(smoothing_kernel).set_params(
                {k: v.to(x.device) for k, v in defaults.items()})
        w = smoothing_kernel.gram(xq, xt)  # [m, n]
        yg = (w * y).sum(dim=-1) / torch.clamp_min(w.sum(dim=-1), 1e-30)
        return dataclasses.replace(self, x_train=xg, y_train=yg)

    def split_at_changepoints(self, locations) -> List["DataInput"]:
        """Segment train and test by change-point thresholds on x[:, 0]
        into half-open intervals [lo, hi)."""
        locs = list(np.sort(np.asarray(locations, np.float64).reshape(-1)))
        edges = [-np.inf] + locs + [np.inf]
        out = []
        xtr0, xte0 = self.x_train[:, 0], self.x_test[:, 0]
        for lo, hi in zip(edges[:-1], edges[1:]):
            mtr = (xtr0 >= lo) & (xtr0 < hi)
            mte = (xte0 >= lo) & (xte0 < hi)
            out.append(dataclasses.replace(
                self, x_train=self.x_train[mtr], y_train=self.y_train[mtr],
                x_test=self.x_test[mte], y_test=self.y_test[mte]))
        return out


def _grid_idx(n: int, size: int) -> np.ndarray:
    return np.unique(np.linspace(0, n - 1, size).round().astype(int))


@dataclasses.dataclass
class BatchDataInput:
    """Batched (instance-stacked) problems: x [b, n, d], y [b, n]; ``fit``
    takes them with one shared parameter set."""

    x: torch.Tensor
    y: torch.Tensor

    def __post_init__(self):
        if self.x.ndim != 3 or self.y.ndim != 2 \
                or tuple(self.x.shape[:2]) != tuple(self.y.shape):
            raise ValueError(
                f"need x [b, n, d] and y [b, n], got {tuple(self.x.shape)} "
                f"and {tuple(self.y.shape)}")

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    def xrange(self) -> torch.Tensor:
        """Per-instance, per-dimension ranges [b, d, 2]."""
        return torch.stack([self.x.min(dim=1).values,
                            self.x.max(dim=1).values], dim=-1)

    def instance(self, i: int) -> DataInput:
        return DataInput(self.x[i], self.y[i], self.x[i], self.y[i])


# --- CSV dataset handlers ---------------------------------------------------

# search order: $GPF_DATA_DIR (read at each call), the package's csv/
# directory, then the repo's data/ directory, which ships d2_mauna_loa.csv
_PKG_DATA_DIR = os.path.join(os.path.dirname(__file__), "csv")
_REPO_DATA_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "data"))


def _find_csv(fname: str):
    dirs = (os.environ.get("GPF_DATA_DIR", _PKG_DATA_DIR), _REPO_DATA_DIR)
    for d in dirs:
        p = os.path.join(d, fname)
        if os.path.exists(p):
            return p
    return None


_NAMED = {
    # name -> file; the x columns are all but the last, y the last
    "solar_irradiance": "d1_solar_irradiance.csv",
    "mauna_loa": "d2_mauna_loa.csv",
    "power_plant": "d3_power_plant.csv",
    "gefcom": "d4_gef_com.csv",
    "temperature": "d8_temperature.csv",
    "births": "d15_births.csv",
}


def read_csv(path: str) -> Tuple[List[str], np.ndarray]:
    """(header, float64 rows) of a CSV with one header line."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header = [h.strip() for h in rows[0]]
    data = np.array([[float(v) for v in r] for r in rows[1:] if r],
                    dtype=np.float64)
    return header, data.reshape(-1, len(header))


def load_csv(path: str, x_cols=None, y_col=None, test_ratio: float = 0.2,
             perm=None, **kw) -> DataInput:
    """A CSV as a :class:`DataInput`: ``y_col`` (default the last column)
    against ``x_cols`` (default, or ``"ALL"``, every other column), min-max
    scaled; ``kw`` as :meth:`DataInput.from_arrays`."""
    header, data = read_csv(path)
    if y_col is None:
        y_col = header[-1]
    if x_cols is None or x_cols == "ALL":
        x_cols = [c for c in header if c != y_col]
    x = data[:, [header.index(c) for c in x_cols]]
    y = data[:, header.index(y_col)]
    return DataInput.from_arrays(x, y, test_ratio=test_ratio, perm=perm, **kw)


def load_named(name: str, test_ratio: float = 0.2, **kw) -> DataInput:
    """A named dataset from its CSV, or from its synthetic stand-in where
    the CSV is absent (only ``data/d2_mauna_loa.csv`` ships)."""
    fname = _NAMED[name]
    path = _find_csv(fname)
    if path is not None:
        return load_csv(path, test_ratio=test_ratio, **kw)
    synth = _SYNTH_FALLBACKS.get(name)
    if synth is not None:
        x, y = synth()
        return DataInput.from_arrays(x, y, test_ratio=test_ratio, **kw)
    raise FileNotFoundError(f"dataset csv not found: {fname}")


# --- synthetic generators (numpy: the JAX package's draws, bit for bit) ----

def synth_se(n: int = 1000, d: int = 1, lengthscale: float = 0.2,
             noise_sd: float = 0.05, seed: int = 0
             ) -> Tuple[np.ndarray, np.ndarray]:
    """y from a GP prior with an SE kernel plus noise (x sorted in [0, 1])."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 1.0, size=(n, d)), axis=0)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    K = np.exp(-0.5 * d2 / lengthscale**2) + 1e-10 * np.eye(n)
    f = np.linalg.cholesky(K) @ rng.standard_normal(n)
    y = f + noise_sd * rng.standard_normal(n)
    return x, y


def synth_mauna_loa(n: int = 720) -> Tuple[np.ndarray, np.ndarray]:
    """A Mauna-Loa-CO₂-shaped series (trend + seasonal + noise)."""
    t = np.linspace(1958.0, 2018.0, n)
    trend = 315.0 + 0.8 * (t - 1958.0) + 0.012 * (t - 1958.0) ** 2
    seasonal = 3.0 * np.sin(2 * np.pi * t) + 0.8 * np.sin(4 * np.pi * t)
    rng = np.random.default_rng(42)
    y = trend + seasonal + 0.3 * rng.standard_normal(n)
    return t[:, None], y


def synth_solar_irradiance(n: int = 800) -> Tuple[np.ndarray, np.ndarray]:
    """A solar-irradiance-shaped series: slow trend + ~11-year cycle."""
    t = np.linspace(1700.0, 2000.0, n)
    rng = np.random.default_rng(1)
    y = (1360.0 + 0.3 * np.sin(2 * np.pi * (t - 1700.0) / 11.0)
         + 0.15 * np.sin(2 * np.pi * (t - 1700.0) / 90.0)
         + 0.05 * rng.standard_normal(n))
    return t[:, None], y


def synth_power_plant(n: int = 2000) -> Tuple[np.ndarray, np.ndarray]:
    """4-D input → power output, the shape of the CCPP dataset (ambient
    temperature, exhaust vacuum, ambient pressure, relative humidity)."""
    rng = np.random.default_rng(3)
    at = rng.uniform(2.0, 36.0, n)
    v = rng.uniform(25.0, 82.0, n)
    ap = rng.uniform(993.0, 1034.0, n)
    rh = rng.uniform(25.0, 100.0, n)
    y = (480.0 - 1.9 * at - 0.3 * v + 0.06 * (ap - 1013.0)
         - 0.015 * rh + 1.2 * rng.standard_normal(n))
    return np.stack([at, v, ap, rh], axis=1), y


def synth_seasonal_series(n: int, start: float, stop: float, base: float,
                          amp: float, period: float, noise_sd: float,
                          seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A generic seasonal 1-D series."""
    t = np.linspace(start, stop, n)
    rng = np.random.default_rng(seed)
    y = (base + amp * np.sin(2 * np.pi * t / period)
         + 0.3 * amp * np.sin(4 * np.pi * t / period)
         + noise_sd * rng.standard_normal(n))
    return t[:, None], y


_SYNTH_FALLBACKS = {
    "mauna_loa": synth_mauna_loa,
    "solar_irradiance": synth_solar_irradiance,
    "power_plant": synth_power_plant,
    "gefcom": lambda: synth_seasonal_series(1500, 0.0, 62.0, 100.0, 30.0,
                                            1.0, 0.05 * 30.0, 4),
    "temperature": lambda: synth_seasonal_series(1000, 0.0, 10.0, 12.0, 8.0,
                                                 1.0, 1.5, 8),
    "births": lambda: synth_seasonal_series(1460, 0.0, 4.0, 10000.0, 600.0,
                                            1.0, 250.0, 15),
}
