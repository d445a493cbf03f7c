"""The composite-expression engine of the PyTorch port (K3 and K4's modules)
against the JAX package's ``ops/pallas_expr.py``.

* The kernels' wrappers on CPU tensors (their plain versions) against the
  Pallas kernels run in interpret mode, float32, at ragged n ≤ 1024: K3
  within 1e-5·max|ref| (``tests/test_pallas_expr.py``'s limit against the
  dense product), K4 within 1e-3 per parameter array relative to its
  largest entry (the on-chip gate ``expr_vjp_mauna``).
* The packing order, the coverage predicate and the routers with a root
  WhiteNoise, incl. the WhiteNoise gradient on duplicated rows.
* The generated code's formulas, run by the PyTorch twin of the emitted
  statements (``expr_codegen.evaluate``), against the leaves' Gram and
  autograd for every leaf kind, scalar and ARD, in float64 (1e-10): the
  only CPU coverage of the arithmetic K4 runs on the card; and PER's
  phase, reduced in float64, in float32 against float64 where the float32
  phase itself is not accurate enough.
"""
import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import gaussianprocessfundamentals_tpu as gpf
import gaussianprocessfundamentals_tpu_torch as gpt
from gaussianprocessfundamentals_tpu.ops import pallas_expr as pe
from gaussianprocessfundamentals_tpu_torch.ops import cuda_expr, expr
from gaussianprocessfundamentals_tpu_torch.ops import expr_codegen as cg
from gaussianprocessfundamentals_tpu_torch.utils.tree import tree_leaves
from torch_parallel_threads import one_blas_thread  # noqa: F401  (autouse)

# The suite runs one pytest-xdist worker per core: torch's own thread pool
# on top of that oversubscribes the CPU and slows every worker.
torch.set_num_threads(1)

HP = jax.lax.Precision.HIGHEST


def _mauna(pkg):
    return (pkg.SquaredExponentialKernel(scaled=True) * pkg.PeriodicKernel()
            + pkg.SquaredExponentialKernel(scaled=True) + pkg.LinearKernel()
            + pkg.WhiteNoiseKernel(scaled=True))


def _mauna_core(pkg):
    return (pkg.SquaredExponentialKernel(scaled=True) * pkg.PeriodicKernel()
            + pkg.SquaredExponentialKernel(scaled=True) + pkg.LinearKernel())


def _ard(name, d):
    def make(pkg):
        return getattr(pkg, name)(dim=d, scaled=True)
    return make


# (expression in either package, d, per-dimension parameters)
KERNEL_CASES = {
    "mauna": (_mauna_core, 1, {}),
    "se-ard-d3": (_ard("SquaredExponentialKernel", 3), 3,
                  {"lengthscale": [0.2, 0.3, 0.4]}),
    "mat52-ard-d3": (_ard("Matern52Kernel", 3), 3,
                     {"lengthscale": [0.3, 0.5, 0.4]}),
}


def _set_ard(jp, ard):
    """Give every leaf param named in ``ard`` its per-dimension value."""
    if "children" in jp:
        return {"children": tuple(_set_ard(c, ard) for c in jp["children"])}
    return {k: jnp.asarray(ard[k], jnp.float32) if k in ard else v
            for k, v in jp.items()}


def _pair(make, d, ard, dtype=np.float32, seed=0, n=400):
    jk = make(gpf)
    jp = jk.init_params([[0.0, 1.0]] * d, n, key=jr.PRNGKey(seed),
                        dtype=jnp.dtype(dtype))
    jp = _set_ard(jp, ard)
    tk = gpt.kernel_from_dict(jk.to_dict())
    gpt.params_from_numpy(tk, jax.tree_util.tree_map(np.asarray, jp),
                          dtype=torch.float32 if dtype == np.float32
                          else torch.float64)
    return jk, jp, tk


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _x(n, d, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(0, 1, (n, d)), axis=0).astype(np.float32)


@pytest.mark.parametrize("case", list(KERNEL_CASES))
@pytest.mark.parametrize("r", [1, 9])
def test_plain_k3_matches_pallas_interpret(case, r):
    make, d, ard = KERNEL_CASES[case]
    jk, jp, tk = _pair(make, d, ard)
    x1, x2 = _x(300, d, 1), _x(520, d, 2)  # 520: one full 512 tile + ragged
    V = np.random.default_rng(3).standard_normal((520, r)).astype(np.float32)
    ref = pe.expr_gram_matvec_cross(jk, jp, jnp.asarray(x1), jnp.asarray(x2),
                                    jnp.asarray(V), interpret=True)
    cuda_expr.expr_gram_matvec_cross.launches = 0
    got = cuda_expr.expr_gram_matvec_cross(
        tk, *map(torch.from_numpy, (x1, x2, V)))
    assert got.dtype == torch.float32 and got.shape == (300, r)
    assert _rel(got, ref) <= 1e-5
    # CPU tensors take the plain version: nothing was launched
    assert cuda_expr.expr_gram_matvec_cross.launches == 0


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_plain_k4_matches_pallas_interpret(case):
    make, d, ard = KERNEL_CASES[case]
    jk, jp, tk = _pair(make, d, ard)
    x1, x2 = _x(300, d, 4), _x(520, d, 5)
    rng = np.random.default_rng(6)
    U = rng.standard_normal((300, 5)).astype(np.float32)
    W = rng.standard_normal((520, 5)).astype(np.float32)
    ref = pe.expr_lowrank_vjp_cross(jk, jp, *map(jnp.asarray, (x1, x2, U, W)),
                                    interpret=True)
    cuda_expr.expr_lowrank_vjp_cross.launches = 0
    flat = cuda_expr.expr_lowrank_vjp_cross(tk, *map(torch.from_numpy,
                                                     (x1, x2, U, W)))
    assert cuda_expr.expr_lowrank_vjp_cross.launches == 0
    got = expr.unpack_grads(tk, flat)
    g, r = _flat(got), _flat(ref)
    assert set(g) == set(r)
    for k in r:
        assert _rel(g[k], r[k]) <= 1e-3, (k, g[k], r[k])


def _flat(tree, path=()):
    """{path: numpy leaf}: JAX orders dict leaves by key, the port by
    parameter, so trees are compared by path."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, path + (k,)).items()}
    if isinstance(tree, (tuple, list)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _flat(sub, path + (i,)).items()}
    return {path: np.asarray(tree)}


PACK_CASES = {
    "mauna": (_mauna_core, 1, {}),
    "rq-ard+per": (lambda pkg: pkg.RationalQuadraticKernel(dim=3)
                   + pkg.PeriodicKernel(dim=3, scaled=True), 3,
                   {"lengthscale": [0.2, 0.3, 0.4]}),
    "lin-ard*const~s+m32": (lambda pkg: pkg.LinearKernel(dim=3)
                            * pkg.ConstantKernel(scaled=True)
                            + pkg.Matern32Kernel(dim=3), 3,
                            {"offset": [0.1, 0.5, 0.9]}),
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_order_and_coverage_match_jax(case):
    make, d, ard = PACK_CASES[case]
    jk, jp, tk = _pair(make, d, ard, seed=7)
    np.testing.assert_array_equal(expr.pack_params(tk).numpy(),
                                  np.asarray(pe.pack_params(jk, jp)))
    assert expr.supported_expr(tk, d) == pe.supported_expr(jk, jp, d)
    gvec = torch.arange(expr.pack_params(tk).numel(), dtype=torch.float32)
    got = _flat(expr.unpack_grads(tk, gvec))
    ref = _flat(pe.unpack_grads(jk, jp, jnp.asarray(gvec.numpy())))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_coverage_names_what_is_missing():
    se = gpt.SquaredExponentialKernel(dim=9)
    se.set_params({"lengthscale": torch.tensor(0.3)})
    assert "d=9 > 8" in expr.unsupported(se, 9)
    big = gpt.SquaredExponentialKernel(dim=8, scaled=True)
    for _ in range(15):
        big = big + gpt.SquaredExponentialKernel(dim=8, scaled=True)
    big.set_params(big.init_params([[0.0, 1.0]] * 8, 100))
    for leaf in big.terms:
        leaf.lengthscale = torch.full((8,), 0.3)
    assert "144 packed parameters > 126" in expr.unsupported(big, 8)
    nested = gpt.PeriodicKernel() * gpt.WhiteNoiseKernel()
    nested.set_params(nested.init_params([[0.0, 1.0]], 100))
    assert "WhiteNoiseKernel below the root Sum" in expr.unsupported(nested, 1)
    per = gpt.PeriodicKernel(dim=2)
    per.set_params({"lengthscale": torch.tensor([0.2, 0.3]),
                    "period": torch.tensor(0.1)})
    assert "cannot be per-dimension" in expr.unsupported(per, 2)


def test_cache_key_follows_child_order_not_canonical_str():
    """Two trees that differ only in child order share ``canonical_str`` but
    pack their parameters in different orders: they get different
    libraries."""
    a = gpt.SquaredExponentialKernel() + gpt.PeriodicKernel()
    b = gpt.PeriodicKernel() + gpt.SquaredExponentialKernel()
    for k in (a, b):
        k.set_params(k.init_params([[0.0, 1.0]], 100))
    assert a.canonical_str() == b.canonical_str()
    assert cuda_expr.expression_key(a, 1) != cuda_expr.expression_key(b, 1)
    src = cuda_expr.generated_source("vjp", a, 1)
    assert "static constexpr int P = 3;" in src and "__global__" in src
    assert "3.141592653589793f" in src and " 0.5 " not in src


def test_built_sources_inline_the_tile_header_so_it_enters_their_hash():
    """K1's and K3's sources include csrc/gram_mma.cuh; what is compiled and
    hashed is the text with the header inlined, so editing the header
    renames (and rebuilds) both libraries."""
    from gaussianprocessfundamentals_tpu_torch.ops import cuda_build

    k = gpt.SquaredExponentialKernel() + gpt.PeriodicKernel()
    k.set_params(k.init_params([[0.0, 1.0]], 100))
    header = (cuda_build.CSRC / "gram_mma.cuh").read_text()
    for text in (cuda_build.expand(
            (cuda_build.CSRC / "gram_matvec.cu").read_text(), "gram_matvec.cu"),
            cuda_expr.generated_source("matvec", k, 1)):
        assert '#include "gram_mma.cuh"' not in text
        assert header in text and '#line 1 "gram_mma.cuh"' in text


def _wn_pair(seed=11):
    """SE + WN~s on d = 2 inputs with 20 duplicated rows
    (``tests/test_pallas_expr.py:171``)."""
    jk = gpf.SquaredExponentialKernel() + gpf.WhiteNoiseKernel(scaled=True)
    jp = {"children": ({"lengthscale": jnp.float32(0.3)},
                       {"variance": jnp.float32(0.5)})}
    tk = gpt.kernel_from_dict(jk.to_dict())
    gpt.params_from_numpy(tk, jax.tree_util.tree_map(np.asarray, jp))
    base = _x(60, 2, seed)
    return jk, jp, tk, np.concatenate([base, base[:20]])


def test_routers_with_root_white_noise_match_jax():
    """The square routers strip WhiteNoise and add its exact coincidence
    term: the product and the WhiteNoise gradient on duplicated rows agree
    with the JAX routers (interpret mode); the diagonal-only sum ΣU∘W would
    not."""
    jk, jp, tk, x = _wn_pair()
    rng = np.random.default_rng(12)
    U = rng.standard_normal((80, 3)).astype(np.float32)
    W = rng.standard_normal((80, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    mv_ref = pe.expr_matvec_for(jk, jp, jnp.asarray(x), interpret=True)(
        jnp.asarray(W))
    assert _rel(cuda_expr.expr_matvec_for(tk, xt)(torch.from_numpy(W)),
                mv_ref) <= 1e-5
    ref = pe.expr_lowrank_vjp_for(jk, jp, jnp.asarray(x), interpret=True)(
        jnp.asarray(U), jnp.asarray(W))
    got = cuda_expr.expr_lowrank_vjp_for(tk, xt)(torch.from_numpy(U),
                                                 torch.from_numpy(W))
    g_wn = float(got["children"][1]["variance"])
    w_wn = float(ref["children"][1]["variance"])
    assert abs(g_wn - w_wn) <= 1e-4 * abs(w_wn)
    assert _rel(got["children"][0]["lengthscale"],
                ref["children"][0]["lengthscale"]) <= 1e-3
    assert abs(float(np.sum(U * W)) - w_wn) > 0.05 * abs(w_wn)


def test_cross_routers_with_white_noise_are_exact():
    """The cross form adds the exact test/train coincidence term (the JAX
    package takes its streamed route there): product and gradient equal the
    full kernel's dense ones."""
    _, _, tk, x = _wn_pair(seed=13)
    tk = tk.double()
    x = torch.from_numpy(x).double()
    xt = torch.cat([x[5:9], torch.rand(6, 2, dtype=torch.float64,
                                       generator=torch.Generator().manual_seed(0))])
    V = torch.randn(80, 4, dtype=torch.float64)
    got = cuda_expr.expr_matvec_cross_for(tk, xt, x)(V)
    torch.testing.assert_close(got, tk.gram(xt, x) @ V, rtol=1e-12, atol=1e-12)
    U = torch.randn(10, 4, dtype=torch.float64)
    g = cuda_expr.expr_lowrank_vjp_cross_for(tk, xt, x)(U, V)
    with tk.differentiable() as p:
        total = torch.sum(tk.gram(xt, x) * (U @ V.T))
        ref = torch.autograd.grad(total, tree_leaves(p))
    for a, b in zip(tree_leaves(g), ref):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
    # a WhiteNoise root alone has no core: the group sums are the product
    wn = gpt.WhiteNoiseKernel(dim=2)
    torch.testing.assert_close(cuda_expr.expr_matvec_for(wn, x)(V),
                               wn.gram(x, x) @ V, rtol=1e-14, atol=0)
    assert cuda_expr.expr_lowrank_vjp_for(wn, x)(V, V) == {}


LEAF_CASES = {
    "se": ("SquaredExponentialKernel", None),
    "se-ard": ("SquaredExponentialKernel", "lengthscale"),
    "per": ("PeriodicKernel", None),
    "lin": ("LinearKernel", None),
    "lin-ard": ("LinearKernel", "offset"),
    "mat32": ("Matern32Kernel", None),
    "mat32-ard": ("Matern32Kernel", "lengthscale"),
    "mat52": ("Matern52Kernel", None),
    "mat52-ard": ("Matern52Kernel", "lengthscale"),
    "rq": ("RationalQuadraticKernel", None),
    "rq-ard": ("RationalQuadraticKernel", "lengthscale"),
    "const": ("ConstantKernel", None),
}


def _twin_check(kernel, d, seed):
    """The emitted value against the kernel's Gram on 40 pairs, and every
    emitted derivative (contracted with a random cotangent) against
    autograd of the same contraction."""
    g = torch.Generator().manual_seed(seed)
    x1 = torch.rand(40, d, generator=g, dtype=torch.float64) * 2.0 - 0.5
    x2 = torch.rand(40, d, generator=g, dtype=torch.float64) * 2.0 - 0.5
    cot = torch.randn(40, generator=g, dtype=torch.float64)
    prog = cg.build_program(kernel, d)
    # the float64 values in pack order (pack_params itself rounds to float32)
    flat = torch.cat([t.reshape(-1) for t in tree_leaves(kernel.get_params())])
    pv = [t.clone().requires_grad_(True) for t in flat]
    assert len(pv) == prog.n_params
    value, ders = cg.evaluate(prog, list(x1.T), list(x2.T), pv)
    ref_value = torch.diagonal(kernel.gram(x1, x2))
    torch.testing.assert_close(value.detach().expand(40), ref_value.detach(),
                               rtol=1e-10, atol=1e-12)
    auto = torch.autograd.grad(torch.sum(value * cot), pv)
    for q, (a, der) in enumerate(zip(auto, ders)):
        emitted = torch.sum(cot * der)
        torch.testing.assert_close(emitted.detach(), a, rtol=1e-10, atol=1e-12,
                                   msg=f"parameter {q}")


@pytest.mark.parametrize("case", list(LEAF_CASES))
@pytest.mark.parametrize("scaled", [False, True])
def test_generated_formulas_match_autograd(case, scaled):
    name, ard = LEAF_CASES[case]
    d = 3
    k = getattr(gpt, name)(dim=d, scaled=scaled)
    p = k.init_params([[0.0, 1.0]] * d, 200, generator=torch.Generator().manual_seed(1),
                      dtype=torch.float64)
    if ard:
        p[ard] = torch.tensor([0.25, 0.4, 0.7], dtype=torch.float64)
    k.set_params(p)
    _twin_check(k, d, seed=2)


def test_generated_formulas_match_autograd_through_operators():
    """The product rule through nested Sum and Product nodes."""
    k = ((gpt.SquaredExponentialKernel(dim=2, scaled=True) * gpt.PeriodicKernel(dim=2)
          + gpt.RationalQuadraticKernel(dim=2))
         * (gpt.LinearKernel(dim=2) + gpt.ConstantKernel(scaled=True))
         * gpt.Matern52Kernel(dim=2))
    k.set_params(k.init_params([[0.0, 1.0]] * 2, 150,
                               generator=torch.Generator().manual_seed(3),
                               dtype=torch.float64))
    _twin_check(k, 2, seed=4)
    mauna = _mauna_core(gpt)
    mauna.set_params(mauna.init_params([[0.0, 1.0]], 100, dtype=torch.float64))
    _twin_check(mauna, 1, seed=5)


@pytest.mark.parametrize("d, ls, period", [(1, 1.0, 1e-4), (1, 5e-5, 0.1),
                                           (2, 5e-4, 0.05)])
def test_generated_per_phase_is_accurate_in_float32(d, ls, period):
    """PER's phase π·man/p reaches 1e4 rad at the period's lower bound
    (10·range/n at n = 100k), and ℓ's lower bound (5·range/n) makes k
    react to its last digits. The generated code reduces the phase in
    float64, so its float32 value and derivatives stay within 1e-5 and
    1e-4 of their float64 selves, where the float32 Gram itself (the phase
    rounded in float32) is off by more than 1e-3."""
    k = gpt.PeriodicKernel(dim=d, scaled=True)
    k.set_params({"lengthscale": torch.tensor(ls), "period": torch.tensor(period),
                  "variance": torch.tensor(1.3)})
    g = torch.Generator().manual_seed(8)
    x1 = torch.rand(200, d, generator=g)
    x2 = torch.rand(300, d, generator=g)
    prog = cg.build_program(k, d)
    pv = [t for t in expr.pack_params(k)]
    v32, d32 = cg.evaluate(prog, [c[:, None] for c in x1.T], [c[None, :] for c in x2.T], pv)
    v64, d64 = cg.evaluate(prog, [c[:, None].double() for c in x1.T],
                           [c[None, :].double() for c in x2.T], [t.double() for t in pv])
    assert v32.dtype == torch.float32
    ref = k.double().gram(x1.double(), x2.double())
    torch.testing.assert_close(v64, ref, rtol=1e-9, atol=1e-9)
    assert float((v32.double() - v64).abs().max()) <= 1e-5 * float(v64.abs().max())
    for a, b in zip(d32, d64):
        assert float((a.double() - b).abs().max()) <= 1e-4 * float(b.abs().max())
    naive = k.float().gram(x1, x2).double()
    assert float((naive - v64).abs().max()) > 1e-3 * float(v64.abs().max())
