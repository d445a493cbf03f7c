"""Load a checkpoint written by the JAX package.

The JAX package saves a fit as ``<path>.json`` (the kernel and mean ASTs,
the noise) and ``<path>.npz`` (the hyperparameters, keyed by their pytree
path, e.g. ``k:['lengthscale']``; ``utils/checkpoint.py:36-94`` there).
This reads both with ``json`` and ``numpy`` only and installs the values in
the port's modules, so weights fitted by the JAX package serve here.
"""
from __future__ import annotations

import json
import re
from typing import Optional, Tuple

import numpy as np
import torch

from gaussianprocessfundamentals_tpu_torch.kernels.base import (
    Kernel,
    kernel_from_dict,
)
from gaussianprocessfundamentals_tpu_torch.means.functions import (
    MeanFunction,
    mean_from_dict,
)

_PATH_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _param_name(key: str) -> str:
    """``"['lengthscale']"`` (a JAX pytree path) or ``"lengthscale"`` →
    ``"lengthscale"``. Nested paths belong to composite nodes, which are
    not ported yet."""
    parts = _PATH_KEY.findall(key)
    if not parts:
        return key
    if len(parts) != 1 or not parts[0][0]:
        raise NotImplementedError(
            f"parameter path {key!r} belongs to a composite node; composite "
            "kernels and means are not ported to the PyTorch package yet"
        )
    return parts[0][0]


def params_from_numpy(module, flat: dict, device=None, dtype=None):
    """Install hyperparameters given as numpy arrays (keys as in the JAX
    checkpoint, ``"['lengthscale']"``, or bare names) into a kernel or mean
    module. Returns the module."""
    params = {
        _param_name(k): torch.tensor(np.asarray(v), device=device,
                                     dtype=dtype)
        for k, v in flat.items()
    }
    return module.set_params(params)


def load(path: str, device=None, dtype=None) -> Tuple[
        Kernel, Optional[MeanFunction], Optional[float]]:
    """Read ``<path>.json`` and ``<path>.npz`` written by the JAX package's
    ``save``; returns ``(kernel, mean, noise)`` with the hyperparameters
    installed in the modules (mean is None when none was saved)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as data:
        arrays = {k: data[k] for k in data.files}
    kernel = kernel_from_dict(meta["kernel"])
    params_from_numpy(
        kernel, {k[2:]: v for k, v in arrays.items() if k.startswith("k:")},
        device, dtype,
    )
    mean = None
    if meta["mean"]:
        mean = mean_from_dict(meta["mean"])
        params_from_numpy(
            mean, {k[2:]: v for k, v in arrays.items() if k.startswith("m:")},
            device, dtype,
        )
    return kernel, mean, meta["noise"]
