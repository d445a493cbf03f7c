"""Which version the Gram·V and low-rank-VJP routers run on a card, and the
plain versions they take for the covariances K1-K4 do not cover, against
the JAX package in float64.

``gram_route`` / ``vjp_route`` decide, from the kernel and d alone, between
the leaf kernels K1 / K2, the generated-expression kernels K3 / K4 and the
plain streamed versions. ChangePoint, Partition, d > 8 (but K2's SE, which
takes any d, as the JAX package's K2 does) and WhiteNoise below the root
Sum take the plain versions, which the JAX package also streams
(``ops/gram_matvec.py:36-74``, ``models/iterative.py:54-61`` there);
malformed parameters, such as a per-dimension PER lengthscale, are refused
by name, since no route computes them. The
routers' closures on the CPU are held against the JAX package's
``streamed_gram_matvec_cross`` and ``lowrank_gram_vjp_cross`` on the same
numpy inputs: Gram·V to 1e-10 relative to max|ref|, the gradient to 1e-9
of its largest entry (float64 both; the two sum the same panels in
different orders, and SE·WN's lengthscale gradient is exactly zero).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.kernels.partition import (
    BoxPartitioning as JBox,
)
from gaussianprocessfundamentals_tpu.kernels.partition import (
    Partition as JPartition,
)
from gaussianprocessfundamentals_tpu.ops.gram_matvec import (
    lowrank_gram_vjp_cross as jax_lowrank_gram_vjp_cross,
)
from gaussianprocessfundamentals_tpu.ops.gram_matvec import (
    streamed_gram_matvec_cross as jax_streamed_gram_matvec_cross,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_gram import (
    fused_matvec_cross_for,
    gram_route,
)
from gaussianprocessfundamentals_tpu_torch.ops.cuda_lrvjp import (
    fused_lowrank_vjp_cross_for,
    vjp_route,
)

# one torch thread per xdist worker (see test_torch_operators.py)
torch.set_num_threads(1)

XR = [[0.0, 1.0], [0.0, 1.0]]


def _set(kernel, d: int, **params):
    """``kernel`` with its default parameters for d inputs, overridden."""
    p = kernel.init_params([[0.0, 1.0]] * d, 100)
    p.update({k: torch.as_tensor(v) for k, v in params.items()})
    return kernel.set_params(p)


def _mauna():
    k = (gpt.SquaredExponentialKernel(scaled=True) * gpt.PeriodicKernel()
         + gpt.SquaredExponentialKernel(scaled=True) + gpt.LinearKernel()
         + gpt.WhiteNoiseKernel(scaled=True))
    return k.set_params(k.init_params([[0.0, 1.0]], 100))


def _init(kernel, d: int):
    return kernel.set_params(kernel.init_params([[0.0, 1.0]] * d, 100))


def _route_cases():
    """(name, kernel, d, Gram·V route, VJP route)."""
    se2 = (gpt.SquaredExponentialKernel(), gpt.SquaredExponentialKernel())
    return [
        ("changepoint", _init(gpt.ChangePoint(children=se2), 1), 1,
         "plain", "plain"),
        ("changepoint + wn", _init(
            gpt.ChangePoint(children=se2) + gpt.WhiteNoiseKernel(scaled=True),
            1), 1, "plain", "plain"),
        ("partition", _init(gpt.Partition(
            children=se2, model=gpt.BoxPartitioning(edges=(0.5,))), 1), 1,
         "plain", "plain"),
        ("mat32 d=9", _set(gpt.Matern32Kernel(dim=9), 9, lengthscale=0.3), 9,
         "plain", "plain"),
        ("se d=9", _set(gpt.SquaredExponentialKernel(dim=9), 9,
                        lengthscale=0.3), 9, "plain", "K2"),
        ("se d=40", _set(gpt.SquaredExponentialKernel(dim=40, scaled=True),
                         40, lengthscale=2.0), 40, "plain", "K2"),
        ("se-ard d=9", _set(gpt.SquaredExponentialKernel(dim=9), 9,
                            lengthscale=[0.3] * 9), 9, "plain", "plain"),
        ("se * wn", _init(gpt.SquaredExponentialKernel()
                          * gpt.WhiteNoiseKernel(scaled=True), 1), 1,
         "plain", "plain"),
        ("per-ard d=2", _set(gpt.PeriodicKernel(dim=2), 2,
                             lengthscale=[0.2, 0.3], period=0.4), 2,
         "cannot be per-dimension", "cannot be per-dimension"),
        ("se * per-ard d=2", _set(gpt.PeriodicKernel(dim=2), 2,
                                  lengthscale=[0.2, 0.3], period=0.4)
         * _set(gpt.SquaredExponentialKernel(dim=2), 2, lengthscale=0.3), 2,
         "cannot be per-dimension", "cannot be per-dimension"),
        ("rq alpha of shape (3,) d=2", _set(
            gpt.RationalQuadraticKernel(dim=2), 2, lengthscale=0.3,
            alpha=[1.0, 2.0, 3.0]), 2, "has shape", "has shape"),
        ("se", _set(gpt.SquaredExponentialKernel(scaled=True), 1,
                    lengthscale=0.1), 1, "K1", "K2"),
        ("se d=8", _set(gpt.SquaredExponentialKernel(dim=8), 8,
                        lengthscale=0.3), 8, "K1", "K2"),
        ("se-ard d=3", _set(gpt.SquaredExponentialKernel(dim=3), 3,
                            lengthscale=[0.2, 0.3, 0.4]), 3, "K1", "K4"),
        ("mat32", _set(gpt.Matern32Kernel(), 1, lengthscale=0.2), 1,
         "K1", "K2"),
        ("mat52", _set(gpt.Matern52Kernel(scaled=True), 1, lengthscale=0.2),
         1, "K1", "K2"),
        ("mat52 d=2", _set(gpt.Matern52Kernel(dim=2), 2, lengthscale=0.2), 2,
         "K3", "K4"),
        ("mauna", _mauna(), 1, "K3", "K4"),
        ("wn", _init(gpt.WhiteNoiseKernel(scaled=True), 1), 1, "K3", "K4"),
    ]


ROUTES = ("K1", "K2", "K3", "K4", "plain")


@pytest.mark.parametrize("case", range(len(_route_cases())),
                         ids=[c[0] for c in _route_cases()])
def test_route_decision(case):
    """The route, or for malformed parameters the refusal that names the
    fault (the expected route is then that name)."""
    name, kernel, d, mv, vjp = _route_cases()[case]
    for route, want in ((gram_route, mv), (vjp_route, vjp)):
        if want in ROUTES:
            assert route(kernel, d) == want, name
        else:
            with pytest.raises(NotImplementedError, match=want):
                route(kernel, d)


def _np(tree):
    return jax.tree_util.tree_map(lambda v: np.array(v), tree)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, path + (i,)).items()}
    return {path: np.asarray(tree, dtype=np.float64)}


def _jax_kernel(name: str):
    """(JAX kernel, its float64 params) of one uncovered covariance at
    d = 2."""
    if name.startswith("changepoint"):
        gate = gpf.ChangePointGate(name.split()[-1])
        jk = gpf.ChangePoint(children=(
            gpf.SquaredExponentialKernel(dim=2, scaled=True),
            gpf.Matern52Kernel(dim=2, scaled=True)), gate=gate)
        jp = jk.init_params(XR, 60, dtype=jnp.float64)
        jp["locations"] = jnp.asarray([0.45])
    elif name == "partition":
        jk = JPartition(children=(gpf.SquaredExponentialKernel(dim=2,
                                                               scaled=True),
                                  gpf.PeriodicKernel(dim=2)),
                        model=JBox(edges=(0.5,), dim=1))
        jp = jk.init_params(XR, 60, dtype=jnp.float64)
    else:  # WhiteNoise below the root Sum, on rows that repeat
        jk = (gpf.SquaredExponentialKernel(dim=2, scaled=True)
              * gpf.WhiteNoiseKernel(scaled=True)) + gpf.LinearKernel(dim=2)
        jp = jk.init_params(XR, 60, dtype=jnp.float64)
    return jk, jp


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0.0, 1.0, (300, 2))
    x2 = rng.uniform(0.0, 1.0, (200, 2))
    x2[:40] = x1[:40]  # coincident rows: the WhiteNoise term is not zero
    V = rng.standard_normal((200, 5))
    U = rng.standard_normal((300, 7))
    W = rng.standard_normal((200, 7))
    return x1, x2, V, U, W


NAMES = ["changepoint sigmoid", "changepoint indicator", "partition",
         "se * wn + lin"]


@pytest.mark.parametrize("name", NAMES)
def test_uncovered_covariances_match_jax_through_the_routers(name):
    jk, jp = _jax_kernel(name)
    tk = gpt.kernel_from_dict(json.loads(json.dumps(jk.to_dict())))
    gpt.params_from_numpy(tk, _np(jp), dtype=torch.float64)
    assert gram_route(tk, 2) == "plain" and vjp_route(tk, 2) == "plain"
    x1, x2, V, U, W = _inputs()
    t = [torch.from_numpy(a) for a in (x1, x2, V, U, W)]
    j = [jnp.asarray(a) for a in (x1, x2, V, U, W)]

    got = fused_matvec_cross_for(tk, t[0], t[1])(t[2]).numpy()
    ref = np.asarray(jax_streamed_gram_matvec_cross(jk, jp, j[0], j[1], j[2],
                                                    block=128))
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()

    g = _flat(fused_lowrank_vjp_cross_for(tk, t[0], t[1])(t[3], t[4]))
    r = _flat(jax_lowrank_gram_vjp_cross(jk, jp, j[0], j[1], j[3], j[4],
                                         block=128))
    assert set(g) == set(r)
    scale = max(np.abs(v).max() for v in r.values())
    for k in r:
        assert np.abs(g[k] - r[k]).max() <= 1e-9 * scale, k
