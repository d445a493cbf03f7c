"""Each leaf of the reference's grammar (``gpbench/reference/leaves/``)
gives the port's covariance or mean, its diagonal, its parameter names and
signs, and its stated starting point, on small inputs in float64."""
import pkgutil

import numpy as np
import pytest
import torch

import gpbench_tiny  # noqa: F401  (puts the repository on the path)
from gpbench.lib import work
from gpbench.reference import gp as ref
from gpbench.reference import leaves

LEAVES = sorted(m.name for m in pkgutil.iter_modules(leaves.__path__))
KERNELS = [t for t in LEAVES if t.endswith("Kernel")]
MEANS = [t for t in LEAVES if t.endswith("Mean")]


def _x(n, d, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, d, generator=g, dtype=torch.float64) * 3.0 - 1.0


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("type_name", KERNELS)
def test_kernel_leaf_matches_the_port(type_name, d):
    import gaussianprocessfundamentals_tpu_torch as gpt

    desc = {"type": type_name, "dim": d, "scaled": True}
    x1, x2 = _x(9, d, 1), _x(7, d, 2)
    xmin, xmax = x1.min(0).values.numpy(), x1.max(0).values.numpy()
    kernel = gpt.kernel_from_dict(desc)
    want = kernel.init_params(np.stack([xmin, xmax], axis=1), x1.shape[0],
                              dtype=torch.float64)
    start = ref.default_params(desc, xmin, xmax)
    assert ref.param_names(desc) == tuple(sorted(want))
    for name in want:
        assert torch.allclose(start[name], want[name].double(), rtol=1e-6)
    # parameters away from the start, so a swapped pair would show
    p = {k: v * (1.3 + 0.1 * i) for i, (k, v) in enumerate(sorted(
        start.items()))}
    kernel.set_params(p)
    assert torch.allclose(ref.kernel_value(desc, p, x1, x2),
                          kernel.gram(x1, x2), rtol=1e-12, atol=1e-12)
    assert torch.allclose(ref.kernel_diag(desc, p, x1), kernel.diag(x1),
                          rtol=1e-12, atol=1e-12)
    signed = {path for path, pos in ref.param_specs(desc) if not pos}
    assert signed == {k for k, pos in kernel.positivity().items() if not pos}
    assert work.value_ops(desc, d) > 0 and work.vjp_ops(desc, d) > 0


@pytest.mark.parametrize("type_name", MEANS)
def test_mean_leaf_matches_the_port(type_name):
    import gaussianprocessfundamentals_tpu_torch as gpt

    desc = {"type": type_name, "dim": 2}
    x = _x(9, 2, 3)
    xmin, xmax = x.min(0).values.numpy(), x.max(0).values.numpy()
    mean = gpt.mean_from_dict(desc)
    want = mean.init_params(np.stack([xmin, xmax], axis=1), x.shape[0],
                            dtype=torch.float64)
    start = ref.default_params(desc, xmin, xmax)
    assert ref.param_names(desc) == tuple(sorted(want))
    for name in want:
        assert torch.allclose(start[name], want[name].double(), rtol=1e-6)
    p = {k: v + 0.7 for k, v in start.items()}
    mean.set_params(p)
    assert torch.allclose(ref.mean_value(desc, p, x), mean(x), rtol=1e-12)


def test_an_unknown_leaf_names_the_file_to_add():
    with pytest.raises(ValueError, match="reference/leaves/NoSuchKernel.py"):
        ref.kernel_value({"type": "NoSuchKernel"}, {}, _x(2, 1, 0),
                         _x(2, 1, 0))
