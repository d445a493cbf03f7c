"""The system under test, built from a configuration file: the port's
``GaussianProcess`` with the described kernel and mean, and the data made
on the device from the seed."""
from __future__ import annotations

import importlib

import numpy as np
import torch

MASK63 = (1 << 63) - 1


def _str_seed(tag: str) -> int:
    return int.from_bytes(tag.encode()[:8].ljust(8, b"\0"), "little")


def seed_for(seed: int, tag: str, i: int = 0) -> int:
    """Deterministic across processes (no ``hash`` randomisation)."""
    ss = np.random.SeedSequence([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
                                 _str_seed(tag) & 0xFFFFFFFF,
                                 _str_seed(tag) >> 32, i])
    return int(ss.generate_state(1, np.uint64)[0]) & MASK63


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_data(cfg: dict, seed: int, device):
    """(x [n, d], y [n]) in float32 on ``device``, drawn from the seed by
    the configuration's generator (``gpbench/data/<generator>.py``)."""
    name = "gpbench.data." + cfg["data"]["generator"]
    try:
        gen = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"unknown data generator: add "
                         f"gpbench/data/{cfg['data']['generator']}.py") from None
    return gen.make(cfg, generator(seed_for(seed, "data"), device), device)


def tensor_tree(tree, device, dtype=torch.float32):
    """A parameter tree of numbers and lists (JSON) as tensors; a list of
    child trees (under "children") becomes a tuple."""
    if isinstance(tree, dict):
        return {k: (tuple(tensor_tree(c, device, dtype) for c in v)
                    if k == "children" else tensor_tree(v, device, dtype))
                for k, v in tree.items()}
    return torch.tensor(tree, dtype=dtype, device=device)


def build_gp(cfg: dict, device, with_params: bool):
    """The port's GaussianProcess of the configuration; with
    ``with_params`` holding the configuration's serving hyperparameters."""
    import gaussianprocessfundamentals_tpu_torch as gpt

    kernel = gpt.kernel_from_dict(cfg["kernel"])
    mean = gpt.mean_from_dict(cfg["mean"])
    if with_params:
        p = cfg["serve_params"]
        kernel.set_params(tensor_tree(p["kernel"], "cpu"))
        mean.set_params(tensor_tree(p["mean"], "cpu"))
    gp = gpt.GaussianProcess(kernel, mean, device=device)
    if with_params:
        gp.noise = torch.tensor(cfg["serve_params"]["noise"], dtype=torch.float32,
                                device=device)
    return gp


def pin_float32() -> None:
    """Full-float32 matmuls, as the port's GPU path requires."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
