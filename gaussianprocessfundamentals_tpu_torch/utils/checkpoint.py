"""Checkpoints in the JAX package's format, both ways.

The JAX package saves a fit as ``<path>.json`` (the kernel and mean ASTs,
the noise) and ``<path>.npz`` (the hyperparameters, keyed by their pytree
path: ``k:['lengthscale']``,
``k:['children']/[0]/['children']/[1]/['period']``, ``m:['children']/[0]/['c']``;
``utils/checkpoint.py:36-94`` there). :func:`load` reads both with ``json``
and ``numpy`` only and installs the values in the port's modules;
:func:`save` writes the same two files from the modules, so a fit from
either package loads in the other. Change points' ``locations`` are leaves
like any other (``k:['locations']``), and a Partition's model is part of
its AST. :func:`stacked_params_from_numpy` reads the JAX package's
per-segment parameters stacked on a leading axis (what its
``fit_segments_vmapped`` returns) into the port's tree of the same layout;
:func:`svgp_params_from_numpy` and :func:`rff_state_from_numpy` carry its
SVGP parameters and random-feature states across.
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
from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_map

_PATH_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _path(key: str) -> list:
    """``"['children']/[0]/['c']"`` → ``["children", 0, "c"]``; a bare
    name is a path of one."""
    parts = _PATH_KEY.findall(key)
    if not parts:
        return [key]
    return [name if name else int(index) for name, index in parts]


def _tuples(node):
    """Dicts keyed by sequence positions in a path become tuples; a position
    with no path (a child with no parameters) becomes an empty dict."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return tuple(_tuples(node.get(i, {})) for i in range(max(node) + 1))
    return {k: _tuples(v) for k, v in node.items()}


def _like(template, tree):
    """``tree`` padded to the operator structure of ``template`` (a module's
    params tree): children after the last one with parameters have no path
    in a checkpoint."""
    if isinstance(template, dict):
        return {k: _like(v, tree[k]) for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return tuple(_like(t, tree[i] if i < len(tree) else {})
                     for i, t in enumerate(template))
    return tree


def tree_from_numpy(params: dict, device=None, dtype=None) -> dict:
    """The JAX package's parameters (numpy or JAX arrays) as the port's
    params tree of tensors. ``params`` is a params tree as the JAX package
    holds it (a ``MeanSum``'s is ``{"children": ({"c": …}, {"slope":
    …})}``), or flat keys: pytree paths as in its checkpoints
    (``"['children']/[0]/['c']"``) or bare names."""
    tree: dict = {}
    for key, value in params.items():
        *head, last = _path(key)
        node = tree
        for part in head:
            node = node.setdefault(part, {})
        node[last] = value
    return tree_map(
        lambda v: torch.tensor(np.asarray(v), device=device, dtype=dtype),
        _tuples(tree),
    )


def stacked_params_from_numpy(module, params: dict, device=None,
                              dtype=None) -> dict:
    """The JAX package's per-segment parameters stacked on a leading axis S
    (as its ``fit_segments_vmapped`` returns them, numpy or JAX arrays, a
    params tree or flat keys as :func:`tree_from_numpy` takes) as the
    port's tree shaped like ``module.get_params()``, every leaf [S, ...]:
    what :func:`..models.segmented.fit_segments_vmapped` returns and
    :func:`..models.segmented.segmented_nll` takes. Nothing is
    installed."""
    return _like(module.get_params(), tree_from_numpy(params, device, dtype))


def params_from_numpy(module, params: dict, device=None, dtype=None):
    """Install the JAX package's parameters (see :func:`tree_from_numpy`)
    in a kernel or mean module, composites included. Returns the
    module."""
    return module.set_params(
        _like(module.get_params(), tree_from_numpy(params, device, dtype)))


def _tensor(a, device=None, dtype=None) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=device, dtype=dtype)


def svgp_params_from_numpy(kernel, params, device=None, dtype=None):
    """The JAX package's ``SVGPParams`` (numpy or JAX arrays; its
    ``kernel_u`` a params tree or flat keys as :func:`tree_from_numpy`
    takes) as the port's :class:`..models.svgp.SVGPParams`, ``kernel_u``
    shaped like ``kernel.positivity()``. Nothing is installed."""
    from gaussianprocessfundamentals_tpu_torch.models.svgp import SVGPParams

    return SVGPParams(
        _like(kernel.positivity(),
              tree_from_numpy(params.kernel_u, device, dtype)),
        *(_tensor(getattr(params, f), device, dtype)
          for f in ("z", "q_mu", "q_sqrt", "log_noise")))


def rff_state_from_numpy(state, device=None, dtype=None):
    """The JAX package's ``RFFState`` (omega [D, d], phase [D], scale) as
    the port's :class:`..models.rff.RFFState`."""
    from gaussianprocessfundamentals_tpu_torch.models.rff import RFFState

    return RFFState(*(_tensor(getattr(state, f), device, dtype)
                      for f in ("omega", "phase", "scale")))


def _flatten(tree) -> dict:
    """Params tree → {pytree path: numpy array}, paths as the JAX package
    writes them (``['name']`` for a dict key, ``[i]`` for a position)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [f"['{k}']"])
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                walk(v, path + [f"[{i}]"])
        else:
            out["/".join(path)] = node.detach().cpu().numpy()

    walk(tree, [])
    return out


def save(path: str, kernel: Kernel, mean: Optional[MeanFunction] = None,
         noise=None, extra: Optional[dict] = None) -> None:
    """Write ``<path>.json`` (ASTs, noise, ``extra``) and ``<path>.npz``
    (the hyperparameters installed in ``kernel`` and ``mean``)."""
    meta = {
        "kernel": kernel.to_dict(),
        "mean": mean.to_dict() if mean is not None else None,
        "noise": float(noise) if noise is not None else None,
        "extra": extra or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)
    arrays = {"k:" + k: v for k, v in _flatten(kernel.get_params()).items()}
    if mean is not None:
        arrays.update({"m:" + k: v
                       for k, v in _flatten(mean.get_params()).items()})
    np.savez(path + ".npz", **arrays)


def load(path: str, device=None, dtype=None) -> Tuple[
        Kernel, Optional[MeanFunction], Optional[float]]:
    """Read ``<path>.json`` and ``<path>.npz`` written by either package's
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
