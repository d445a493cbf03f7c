"""The composite-expression kernels K3 (Gram·V) and K4 (the low-rank-
cotangent gradient), and the routers that hand them to the solvers.

Counterpart of ``gaussianprocessfundamentals_tpu/ops/pallas_expr.py``:
``expr_gram_matvec_cross`` (``:394``), ``expr_lowrank_vjp_cross``
(``:481``), ``expr_matvec_for`` (``:573``), ``expr_matvec_cross_for``
(``:594``), ``expr_lowrank_vjp_cross_for`` (``:609``) and
``expr_lowrank_vjp_for`` (``:625``). The TPU kernels become CUDA C++ for
sm_90a: the templates ``csrc/expr_matvec.cu`` and ``csrc/expr_vjp.cu``,
each compiled with the code :mod:`.expr_codegen` emits for one expression.
A library is built with nvcc at first use into ``csrc/_build/`` and cached
by the expression's AST JSON, input dimension and parameter sizes (not by
``canonical_str``, which sorts children and so maps two packing orders to
one string); the file itself is named by the hash of its source.

Routing is by the device of the tensors, as for K1 and K2:

* CPU tensors take the plain versions (:mod:`.expr`);
* CUDA tensors launch the kernel, or raise and name what the kernel does
  not cover (d > 8, more than 126 packed parameters, an operator or leaf
  with no tile evaluator). A failed nvcc raises too.

The routers strip WhiteNoise from the root Sum and add its exact
row-coincidence term (:class:`.expr.RowGroups`, grouped once per router),
to the product and to the gradient, in the square and the cross forms. A
router checks coverage, finds the library and packs the parameters once
(the vector stays on the device); its closures only check the tensors and
launch.
"""
from __future__ import annotations

import ctypes
import json

import torch

from gaussianprocessfundamentals_tpu_torch.ops import cuda_build
from gaussianprocessfundamentals_tpu_torch.ops.expr import (
    RowGroups,
    layout,
    pack_params,
    plain_expr_gram_matvec_cross,
    plain_expr_lowrank_vjp_cross,
    split_white_noise,
    unpack_grads,
    unsupported,
    with_white_noise,
    wn_amplitude,
)
from gaussianprocessfundamentals_tpu_torch.ops.expr_codegen import (
    build_program,
    cuda_struct,
)

_TEMPLATES = {"matvec": "expr_matvec.cu", "vjp": "expr_vjp.cu"}
_LIBS: dict = {}  # (template, expression key) -> ctypes entry points


def expression_key(kernel, d: int) -> str:
    """What a built library depends on: the AST, d and every packed
    parameter's size (scalar or per dimension)."""
    sizes = [[name, sz] for _, slots, _ in layout(kernel)
             for name, (_, sz) in slots.items()]
    return json.dumps({"ast": kernel.to_dict(), "d": d, "sizes": sizes},
                      sort_keys=True)


def generated_source(template: str, kernel, d: int) -> str:
    """The full CUDA source of one expression's K3 ("matvec") or K4
    ("vjp"): the generated ``struct Expr``, then the template with its
    headers inlined."""
    name = _TEMPLATES[template]
    return (f"// generated for {kernel} at d = {d}\n"
            f"// {expression_key(kernel, d)}\n"
            + cuda_struct(build_program(kernel, d))
            + f'#line 1 "{name}"\n'
            + cuda_build.expand((cuda_build.CSRC / name).read_text(), name))


# K3 with 128-column tiles (csrc/gram_mma.cuh, "Registers")
_NARROW_K3 = "#define EXPR_MAX_COLS 128\n"


def library(template: str, kernel, d: int):
    """The expression's K3 or K4 library, built unless it exists.

    K3 is built with 256-column tiles first; where ptxas reports that they
    spill registers for this expression (cheap ones, whose evaluation it
    schedules far ahead), it is rebuilt with 128-column tiles, which
    evaluate each pair twice at r > 128."""
    text = generated_source(template, kernel, d)
    path = cuda_build.build_generated(f"expr_{template}", text)
    if template == "matvec" and any(
            k.get("spill_stores") or k.get("spill_loads")
            for k in cuda_build.ptxas_report(path)):
        path = cuda_build.build_generated(f"expr_{template}", _NARROW_K3 + text)
    return path


def _build_job(template: str, kernel, d: int):
    return lambda: library(template, kernel, d)


def _bind(template: str, path) -> tuple:
    """(entry point, tile edge) of a built library; the tile edge sizes
    K4's partial buffer."""
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, f"gpf_expr_{template}")
    n_ptr = 5 if template == "matvec" else 6
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, (lib.gpf_expr_vjp_tile() if template == "vjp" else None)


def _lib(template: str, kernel, d: int) -> tuple:
    """(entry point, tile edge) of the expression's library, built and
    loaded at first use."""
    key = (template, expression_key(kernel, d))
    if key not in _LIBS:
        _LIBS[key] = _bind(template, _build_job(template, kernel, d)())
    return _LIBS[key]


def prebuild(kernels_and_dims) -> None:
    """Build K3 and K4 for every (kernel, d), one nvcc per library, all
    started together; WhiteNoise is stripped from each root first, as the
    routers do."""
    todo = {}
    for kernel, d in kernels_and_dims:
        core, _ = split_white_noise(kernel)
        if core is None:
            continue
        for template in _TEMPLATES:
            key = (template, expression_key(core, d))
            if key not in _LIBS:
                todo[key] = (template, _build_job(template, core, d))
    paths = cuda_build.build_concurrently(job for _, job in todo.values())
    for (key, (template, _)), path in zip(todo.items(), paths):
        _LIBS[key] = _bind(template, path)


def _resolve(template: str, kernel, x1, pv, what: str) -> tuple:
    """(entry point, tile edge, packed vector) of one expression on x1's
    card: checks coverage and ``pv``, builds or finds the library. A router
    calls this once; the public wrappers once per call."""
    if x1.device.type != "cuda" or x1.ndim != 2:
        raise ValueError(f"{what}: x1 must be [n, d] on a CUDA device or all "
                         f"tensors on the CPU, got {tuple(x1.shape)} on {x1.device}")
    d = x1.shape[1]
    why = unsupported(kernel, d)
    if why is not None:
        raise NotImplementedError(
            f"{what} does not cover {kernel.canonical_str()} at d={d}: {why}")
    if pv is None:
        pv = pack_params(kernel)
    n_params = sum(sz for _, slots, _ in layout(kernel) for _, sz in slots.values())
    if pv.dtype != torch.float32 or pv.device != x1.device or (
            pv.shape != (n_params,)):
        raise ValueError(f"{what}: pv must be float32 [{n_params}] on "
                         f"{x1.device}, got {pv.dtype} {tuple(pv.shape)} on "
                         f"{pv.device}")
    fn, tile = _lib(template, kernel, d)
    return fn, tile, pv.contiguous()


def _check_tensors(name: str, tensors, pv) -> None:
    """The checks every launch makes (a few attribute reads)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; "
                         "need all on the CPU or all on one CUDA device")
    if any(t.requires_grad for t in tensors) or pv.requires_grad:
        raise RuntimeError(f"{name} computes no autograd graph: its inputs "
                           "must not require grad")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32 tensors, got "
                        f"{[str(t.dtype) for t in tensors]}")


def _matvec(fn, x1, x2, V, pv):
    """Launch K3 through a resolved entry point."""
    _check_tensors("expr_gram_matvec_cross", (x1, x2, V), pv)
    if x2.ndim != 2 or V.ndim not in (1, 2) or x2.shape[1] != x1.shape[1] or (
            V.shape[0] != x2.shape[0]):
        raise ValueError(f"shape mismatch: x1 {tuple(x1.shape)}, x2 "
                         f"{tuple(x2.shape)}, V {tuple(V.shape)}")
    n1, n2 = x1.shape[0], x2.shape[0]
    vec = V.ndim == 1
    x1c, x2c = x1.contiguous(), x2.contiguous()
    Vc = (V[:, None] if vec else V).contiguous()
    r = Vc.shape[1]
    out = torch.empty((n1, r), dtype=torch.float32, device=x1.device)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x1c.data_ptr(), x2c.data_ptr(), Vc.data_ptr(), pv.data_ptr(),
                 out.data_ptr(), n1, n2, r, stream)
    if err != 0:
        raise RuntimeError(f"gpf_expr_matvec launch failed: cudaError {err}")
    expr_gram_matvec_cross.launches += 1
    return out[:, 0] if vec else out


def _vjp(fn, tile, x1, x2, U, W, pv):
    """Launch K4 through a resolved entry point."""
    _check_tensors("expr_lowrank_vjp_cross", (x1, x2, U, W), pv)
    if x2.ndim != 2 or U.ndim != 2 or W.ndim != 2 or x2.shape[1] != x1.shape[1] or (
            U.shape != (x1.shape[0], W.shape[1])) or W.shape[0] != x2.shape[0]:
        raise ValueError(
            f"shape mismatch: x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, "
            f"U {tuple(U.shape)}, W {tuple(W.shape)}")
    n1, n2, r = x1.shape[0], x2.shape[0], W.shape[1]
    if n1 == 0 or n2 == 0 or r == 0:
        return torch.zeros_like(pv)
    blocks = -(-n1 // tile) * -(-n2 // tile)
    partial = torch.empty((blocks, pv.shape[0]), dtype=torch.float32,
                          device=x1.device)
    x1c, x2c, Uc, Wc = (t.contiguous() for t in (x1, x2, U, W))
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x1c.data_ptr(), x2c.data_ptr(), Uc.data_ptr(), Wc.data_ptr(),
                 pv.data_ptr(), partial.data_ptr(), n1, n2, r, stream)
    if err != 0:
        raise RuntimeError(f"gpf_expr_vjp launch failed: cudaError {err}")
    expr_lowrank_vjp_cross.launches += 1
    # per-tile partials summed in float64 on the device: no float32 chain
    # across tiles
    return partial.double().sum(dim=0).float()


def expr_gram_matvec_cross(kernel, x1, x2, V, pv=None):
    """K(x1, x2) @ V for a covered expression (WhiteNoise stripped), with K
    tiles kept in registers (never in memory).

    x1: [n1, d], x2: [n2, d], V: [n2, r] or [n2], float32 → [n1, r] (or
    [n1]). ``pv`` is the packed parameter vector (:func:`.expr.pack_params`,
    made here when None).

    CPU tensors take :func:`.expr.plain_expr_gram_matvec_cross`; CUDA
    tensors launch the kernel on the current stream and add one to
    ``expr_gram_matvec_cross.launches``. Each call checks coverage and
    finds the library; the routers do that once.
    """
    if {t.device.type for t in (x1, x2, V)} == {"cpu"}:
        return plain_expr_gram_matvec_cross(kernel, x1, x2, V)
    fn, _, pv = _resolve("matvec", kernel, x1, pv, "expr_gram_matvec_cross")
    return _matvec(fn, x1, x2, V, pv)


expr_gram_matvec_cross.launches = 0


def expr_lowrank_vjp_cross(kernel, x1, x2, U, W, pv=None):
    """∂/∂pv of Σᵢⱼ (UWᵀ)ᵢⱼ K(x1, x2)ᵢⱼ for a covered expression (WhiteNoise
    stripped), in one pass with analytic in-tile derivatives: a flat
    vector in pack order (:func:`.expr.unpack_grads` makes it a params
    tree). K and UWᵀ never reach memory.

    x1: [n1, d], x2: [n2, d], U: [n1, r], W: [n2, r], float32 → float32
    [P]. ``pv`` as for :func:`expr_gram_matvec_cross`.

    CPU tensors take :func:`.expr.plain_expr_lowrank_vjp_cross`; CUDA
    tensors launch the kernel on the current stream and add one to
    ``expr_lowrank_vjp_cross.launches``.
    """
    if {t.device.type for t in (x1, x2, U, W)} == {"cpu"}:
        return plain_expr_lowrank_vjp_cross(kernel, x1, x2, U, W)
    fn, tile, pv = _resolve("vjp", kernel, x1, pv, "expr_lowrank_vjp_cross")
    return _vjp(fn, tile, x1, x2, U, W, pv)


expr_lowrank_vjp_cross.launches = 0


def _split(kernel, x1, x2, template: str):
    """(core, launch, WhiteNoise amplitude, row groups) of a router:
    WhiteNoise stripped from the root; ``launch`` runs the template on the
    core with its coverage, library and packed parameters resolved here,
    once (the plain version on the CPU). On a card the core must be
    covered, else this raises and names what is missing."""
    core, wn = split_white_noise(kernel)
    launch = None
    if core is not None and x1.device.type == "cuda":
        d = x1.shape[-1]
        why = unsupported(core, d)
        if why is not None:
            raise NotImplementedError(
                f"{kernel.canonical_str()} at d={d}: no CUDA kernel covers it "
                f"(K1/K2 take SE and Matérn leaves, K3/K4 expressions): {why}")
        fn, tile, pv = _resolve(template, core, x1, None, "K3/K4")
        if template == "matvec":
            def launch(V):
                return _matvec(fn, x1, x2, V, pv)
        else:
            def launch(U, W):
                return _vjp(fn, tile, x1, x2, U, W, pv)
    elif core is not None:
        plain = (plain_expr_gram_matvec_cross if template == "matvec"
                 else plain_expr_lowrank_vjp_cross)

        def launch(*args):
            return plain(core, x1, x2, *args)
    if not wn:
        return core, launch, None, None
    return core, launch, wn_amplitude(wn, x1), RowGroups(
        x1, None if x2 is x1 else x2)


def expr_matvec_cross_for(kernel, x1, x2):
    """A ``V -> K(x1, x2) @ V`` closure: K3 on the stripped core, plus the
    exact row-coincidence term of a root WhiteNoise."""
    core, launch, amp, groups = _split(kernel, x1, x2, "matvec")

    def mv(V):
        out = None if core is None else launch(V)
        if groups is not None:
            wn = amp * groups.matvec(V)
            out = wn if out is None else out + wn
        return out

    return mv


def expr_matvec_for(kernel, x):
    """Square form of :func:`expr_matvec_cross_for`."""
    return expr_matvec_cross_for(kernel, x, x)


def expr_lowrank_vjp_cross_for(kernel, x1, x2):
    """A ``(U, W) -> grads`` closure giving the gradient of Σ(UWᵀ)∘K(x1, x2)
    as a tree shaped like ``kernel.get_params()``: K4 on the stripped core;
    each scaled root WhiteNoise's variance gradient is Σᵢⱼ(UWᵀ)ᵢⱼ·Eqᵢⱼ
    over the exact row-coincidence matrix, as group sums in O(n·r)."""
    core, launch, _, groups = _split(kernel, x1, x2, "vjp")

    def vjp(U, W):
        g_core = None if core is None else unpack_grads(core, launch(U, W))
        if groups is None:
            return g_core
        return with_white_noise(kernel, g_core, groups.contract(U, W))

    return vjp


def expr_lowrank_vjp_for(kernel, x):
    """Square form of :func:`expr_lowrank_vjp_cross_for`."""
    return expr_lowrank_vjp_cross_for(kernel, x, x)
