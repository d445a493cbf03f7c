"""Generate the CUDA C++ tile code for one kernel expression.

Counterpart of ``_compile_tile_eval`` in
``gaussianprocessfundamentals_tpu/ops/pallas_expr.py:259-365``, which
unrolled the AST walk into the Pallas tile body at trace time. Here the walk
emits straight-line code, once per expression, into a ``struct Expr`` that
the kernel templates ``csrc/expr_matvec.cu`` (K3) and ``csrc/expr_vjp.cu``
(K4) are compiled with:

* ``init(pv)`` reads the packed parameters from device memory once per
  thread and forms the per-leaf constants (1/ℓ², π/p, ...);
* ``value(xa, xb)`` is the expression's value for one pair of input rows;
* ``grad(xa, xb, cot, g)`` adds cot·∂value/∂pv_q to ``g[q]`` for every
  packed parameter q. Pallas took ``jax.grad`` of the tile body
  (``pallas_expr.py:457-460``); here each leaf's analytic derivatives are
  emitted and combined by the product rule: a leaf's multiplier is the
  product of its siblings' values under every Product on its path.

The code is a :class:`Program` of ``name = expression`` statements in a
small language that is both C and Python (``+ - * /``, calls of ``expf``,
``sinf``, ``cosf``, ``logf``, ``fabsf`` and of the two helpers ``inv_lo``
and ``per_phase``, names, and literals written with a decimal point).
:func:`cuda_struct` prints it as C (float literals get an ``f``; the
helpers are defined before the struct); :func:`evaluate` runs the very
same statements in PyTorch, so the CPU tests can hold every emitted formula
against autograd.

Distances are direct per-dimension differences at every d (``df{k}``);
PER and Matérn take the Manhattan distance, as ``_compile_tile_eval`` does.
PER's phase π·man/p is reduced by whole half-turns in float64
(``per_phase``) before ``sinf``/``cosf``: in float32 it carries an absolute
error of ~1e-7 of itself, which a sharp PER (small ℓ) or a short period
turns into relative errors of 1e-2 in the gradient's cancelling sums.
"""
from __future__ import annotations

import math
import re
from typing import List, NamedTuple, Tuple

import torch

from gaussianprocessfundamentals_tpu_torch.kernels.operators import Sum
from gaussianprocessfundamentals_tpu_torch.ops.expr import layout

Stmt = Tuple[str, str]


class Program(NamedTuple):
    d: int
    n_params: int
    prologue: List[Stmt]  # once per thread, from p0 .. p{P-1}
    value: List[Stmt]  # per pair, from a0 .. a{d-1} and b0 .. b{d-1}
    root: str  # the name holding the expression's value
    grad: List[Stmt]  # per pair, after ``value``
    grads: List[str]  # names of ∂value/∂p_q for q = 0 .. P-1


def _sum(terms) -> str:
    return " + ".join(terms)


def _leaf(i: int, kind: str, slots: dict, scaled: bool, d: int, pro, val,
          grad) -> Tuple[str, dict]:
    """Emit leaf ``i``; returns (value name, {param index: ∂value name})."""
    L = f"k{i}_"
    ders = {}

    def p(name, k=0):
        off, sz = slots[name]
        return f"p{off + (k if sz > 1 else 0)}"

    def ard(name):
        return slots[name][1] > 1

    if kind in ("se", "rq"):
        if ard("lengthscale"):
            for k in range(d):
                pro.append((f"{L}il{k}", f"1.0 / {p('lengthscale', k)}"))
                val.append((f"{L}t{k}", f"df{k} * {L}il{k}"))
            val.append((f"{L}d2", _sum(f"{L}t{k} * {L}t{k}" for k in range(d))))
        else:
            pro.append((f"{L}il2", f"1.0 / ({p('lengthscale')} * {p('lengthscale')})"))
            val.append((f"{L}d2", f"({_sum(f'df{k} * df{k}' for k in range(d))}) * {L}il2"))
        if kind == "se":
            val.append((f"{L}u", f"expf(-0.5 * {L}d2)"))
            # ∂k/∂ℓ = k·Δ²/ℓ³ (per dimension for ARD)
            if ard("lengthscale"):
                for k in range(d):
                    grad.append((f"{L}dl{k}", f"{L}u * {L}t{k} * {L}t{k} * {L}il{k}"))
            else:
                grad.append((f"{L}dl", f"{L}u * {L}d2 / {p('lengthscale')}"))
        else:
            al = p("alpha")
            pro.append((f"{L}h", f"0.5 / {al}"))
            val.append((f"{L}b", f"1.0 + {L}d2 * {L}h"))
            val.append((f"{L}lb", f"logf({L}b)"))
            val.append((f"{L}u", f"expf(-{al} * {L}lb)"))
            # ∂k/∂α = k·(d²/(2αb) − ln b); ∂k/∂ℓ = k·d²/(ℓb)
            grad.append((f"{L}da", f"{L}u * ({L}d2 * {L}h / {L}b - {L}lb)"))
            ders[int(al[1:])] = f"{L}da"
            if ard("lengthscale"):
                for k in range(d):
                    grad.append((f"{L}dl{k}", f"{L}u * {L}t{k} * {L}t{k} / "
                                 f"({p('lengthscale', k)} * {L}b)"))
            else:
                grad.append((f"{L}dl", f"{L}u * {L}d2 / ({p('lengthscale')} * {L}b)"))
        _lengthscale_ders(L, slots, d, ders)
    elif kind == "per":
        ls, per = p("lengthscale"), p("period")
        pro.append((f"{L}w", f"{math.pi!r} / {per}"))
        pro.append((f"{L}il2", f"1.0 / ({ls} * {ls})"))
        pro.append((f"{L}iph", f"1.0 / {per}"))
        pro.append((f"{L}ipl", f"inv_lo({per}, {L}iph)"))
        val.append((f"{L}arg", f"({_sum(f'ad{k}' for k in range(d))}) * {L}w"))
        # s = ±sin(π·man/p) from the phase reduced in float64 (the float32
        # phase reaches 1e4 rad at the period's lower bound); s², s·c and
        # the value do not depend on the sign
        ab = ", ".join(f"a{k}, b{k}" for k in range(d))
        val.append((f"{L}red", f"per_phase({L}iph, {L}ipl, {ab})"))
        val.append((f"{L}s", f"sinf({L}red)"))
        val.append((f"{L}u", f"expf(-2.0 * {L}s * {L}s * {L}il2)"))
        # with s = sin(π·man/p): ∂k/∂ℓ = k·4s²/ℓ³,
        # ∂k/∂p = k·4π·man·s·cos(π·man/p)/(ℓ²p²)
        grad.append((f"{L}c", f"cosf({L}red)"))
        grad.append((f"{L}dl", f"{L}u * 4.0 * {L}s * {L}s * {L}il2 / {ls}"))
        grad.append((f"{L}dp", f"{L}u * 4.0 * {L}s * {L}c * {L}il2 * {L}arg / {per}"))
        ders[int(ls[1:])] = f"{L}dl"
        ders[int(per[1:])] = f"{L}dp"
    elif kind == "lin":
        val.append((f"{L}u", _sum(
            f"(a{k} - {p('offset', k)}) * (b{k} - {p('offset', k)})"
            for k in range(d))))
        # ∂k/∂cₖ = 2cₖ − x1ₖ − x2ₖ; a scalar offset sums over the dimensions
        if ard("offset"):
            for k in range(d):
                c = p("offset", k)
                grad.append((f"{L}dc{k}", f"2.0 * {c} - a{k} - b{k}"))
                ders[int(c[1:])] = f"{L}dc{k}"
        else:
            c = p("offset")
            grad.append((f"{L}dc", _sum(f"2.0 * {c} - a{k} - b{k}" for k in range(d))))
            ders[int(c[1:])] = f"{L}dc"
    elif kind in ("mat32", "mat52"):
        const = math.sqrt(3.0) if kind == "mat32" else math.sqrt(5.0)
        if ard("lengthscale"):
            for k in range(d):
                pro.append((f"{L}c{k}", f"{const!r} / fabsf({p('lengthscale', k)})"))
            val.append((f"{L}f", _sum(f"ad{k} * {L}c{k}" for k in range(d))))
        else:
            pro.append((f"{L}c", f"{const!r} / fabsf({p('lengthscale')})"))
            val.append((f"{L}f", f"({_sum(f'ad{k}' for k in range(d))}) * {L}c"))
        val.append((f"{L}e", f"expf(-{L}f)"))
        if kind == "mat32":
            val.append((f"{L}u", f"(1.0 + {L}f) * {L}e"))
            grad.append((f"{L}g", f"-{L}f * {L}e"))  # ∂k/∂f
        else:
            val.append((f"{L}u", f"(1.0 + {L}f + {L}f * {L}f / 3.0) * {L}e"))
            grad.append((f"{L}g", f"-{L}f * (1.0 + {L}f) * {L}e / 3.0"))
        # ∂f/∂ℓ = −f/ℓ; ARD: ∂f/∂ℓₖ = −c|Δₖ|/(ℓₖ|ℓₖ|)
        if ard("lengthscale"):
            for k in range(d):
                grad.append((f"{L}dl{k}", f"-{L}g * ad{k} * {L}c{k} / "
                             f"{p('lengthscale', k)}"))
        else:
            grad.append((f"{L}dl", f"-{L}g * {L}f / {p('lengthscale')}"))
        _lengthscale_ders(L, slots, d, ders)
    elif kind == "const":
        val.append((f"{L}u", p("c")))
        ders[int(p("c")[1:])] = "1.0"
    else:  # pragma: no cover - layout() admits only the kinds above
        raise AssertionError(kind)

    if not scaled:
        return f"{L}u", ders
    var = p("variance")
    val.append((f"{L}v", f"{var} * {L}u"))
    for q, name in list(ders.items()):
        grad.append((f"{L}s{q}", f"{var} * {name}"))
        ders[q] = f"{L}s{q}"
    ders[int(var[1:])] = f"{L}u"
    return f"{L}v", ders


def _lengthscale_ders(L, slots, d, ders):
    off, sz = slots["lengthscale"]
    if sz > 1:
        for k in range(d):
            ders[off + k] = f"{L}dl{k}"
    else:
        ders[off] = f"{L}dl"


def build_program(kernel, d: int) -> Program:
    """The straight-line program of ``kernel`` (WhiteNoise stripped, covered
    by :func:`..ops.expr.unsupported`) at input dimension ``d``."""
    slots_by_leaf = layout(kernel)
    n_params = sum(sz for _, slots, _ in slots_by_leaf for _, sz in slots.values())
    pro: List[Stmt] = []
    val: List[Stmt] = []
    grad: List[Stmt] = []
    for k in range(d):
        val.append((f"df{k}", f"a{k} - b{k}"))
        val.append((f"ad{k}", f"fabsf(df{k})"))
    leaves = iter(enumerate(slots_by_leaf))
    per_leaf = {}  # id(node) -> {param index: ∂value name}

    def emit(node) -> str:
        if not node.terms:
            i, (kind, slots, scaled) = next(leaves)
            name, ders = _leaf(i, kind, slots, scaled, d, pro, val, grad)
            per_leaf[id(node)] = ders
            return name
        parts = [emit(c) for c in node.terms]
        name = f"n{len(val)}"
        val.append((name, node._SEP.join(parts)))
        node_parts[id(node)] = parts
        return name

    node_parts = {}
    root = emit(kernel)

    grads = ["0.0"] * n_params

    def multiply(node, mult):
        """Distribute the multiplier ``mult`` (a name, or None for 1) down
        the tree: a Product child's multiplier is ``mult`` times its
        siblings' values."""
        if not node.terms:
            for q, der in per_leaf[id(node)].items():
                if mult is None:
                    grads[q] = der
                else:
                    name = f"g{q}"
                    grad.append((name, f"{mult} * {der}"))
                    grads[q] = name
            return
        parts = node_parts[id(node)]
        for j, c in enumerate(node.terms):
            factors = ([mult] if mult else []) + [v for i, v in enumerate(parts)
                                                 if i != j]
            if type(node) is Sum or not factors:
                multiply(c, mult)
                continue
            name = f"m{len(grad)}"
            grad.append((name, " * ".join(factors)))
            multiply(c, name)

    multiply(kernel, None)
    return Program(d, n_params, pro, val, root, grad, grads)


_FLOAT = re.compile(r"(?<![\w.])(\d+\.\d*(?:[eE][-+]?\d+)?)(?![\w.])")


def _c(expr: str) -> str:
    """An expression as C: every literal a float."""
    return _FLOAT.sub(r"\1f", expr)


def cuda_struct(program: Program) -> str:
    """The ``struct Expr`` the kernel templates are compiled with."""
    d, P = program.d, program.n_params
    members = [f"p{q}" for q in range(P)] + [n for n, _ in program.prologue]
    loads = "".join(f"    const float a{k} = xa[{k}];\n"
                    f"    const float b{k} = xb[{k}];\n" for k in range(d))
    body_val = "".join(f"    const float {n} = {_c(e)};\n" for n, e in program.value)
    body_grad = "".join(f"    const float {n} = {_c(e)};\n" for n, e in program.grad)
    acc = "".join(f"    g[{q}] = fmaf(cot, {_c(name)}, g[{q}]);\n"
                  for q, name in enumerate(program.grads))
    init = "".join(f"    p{q} = pv[{q}];\n" for q in range(P)) + "".join(
        f"    {n} = {_c(e)};\n" for n, e in program.prologue)
    ab_args = ", ".join(f"float a{k}, float b{k}" for k in range(d))
    man = " + ".join(f"fabs((double)a{k} - (double)b{k})" for k in range(d))
    return (
        "// the float32 residual of 1/p: 1/p = hi + lo to ~48 bits\n"
        "__device__ __forceinline__ float inv_lo(float p, float hi) {\n"
        "  return (float)(1.0 / (double)p - (double)hi);\n"
        "}\n"
        "// π·(t − rint(t)) for t = Σ|a − b|/p, in float64: sin and cos of it\n"
        "// are ±sin(π·t) and ±cos(π·t) with one sign\n"
        "__device__ __forceinline__ float per_phase(float iph, float ipl, "
        f"{ab_args}) {{\n"
        f"  const double t = ({man}) * ((double)iph + (double)ipl);\n"
        "  return (float)((t - rint(t)) * 3.141592653589793);\n"
        "}\n"
        "struct Expr {\n"
        f"  static constexpr int D = {d};\n"
        f"  static constexpr int P = {P};\n"
        f"  float {', '.join(members)};\n"
        "  __device__ __forceinline__ void init(const float* __restrict__ pv) {\n"
        f"{init}"
        "  }\n"
        "  __device__ __forceinline__ float value(const float* __restrict__ xa,\n"
        "                                        const float* __restrict__ xb) const {\n"
        f"{loads}{body_val}"
        f"    return {program.root};\n"
        "  }\n"
        "  __device__ __forceinline__ void grad(const float* __restrict__ xa,\n"
        "                                       const float* __restrict__ xb,\n"
        "                                       float cot, float* g) const {\n"
        f"{loads}{body_val}    (void){program.root};\n{body_grad}{acc}"
        "  }\n"
        "};\n"
    )


def _inv_lo(p, hi):
    return (1.0 / p.double() - hi.double()).to(hi.dtype)


def _per_phase(iph, ipl, *ab):
    man = sum(torch.abs(a.double() - b.double()) for a, b in zip(ab[::2], ab[1::2]))
    t = man * (iph.double() + ipl.double())
    return ((t - torch.round(t)) * math.pi).to(iph.dtype)


_TORCH_FUNCS = {"expf": torch.exp, "sinf": torch.sin, "cosf": torch.cos,
                "logf": torch.log, "fabsf": torch.abs, "inv_lo": _inv_lo,
                "per_phase": _per_phase}


def evaluate(program: Program, a, b, pv):
    """Run the program's statements in PyTorch: ``a`` and ``b`` are lists of
    d tensors (one per input dimension, any broadcastable shape), ``pv`` a
    list of the P parameters. Returns (value, [∂value/∂p_q])."""
    ns = dict(_TORCH_FUNCS)
    ns.update({f"p{q}": v for q, v in enumerate(pv)})
    ns.update({f"a{k}": v for k, v in enumerate(a)})
    ns.update({f"b{k}": v for k, v in enumerate(b)})
    for name, expr in program.prologue + program.value + program.grad:
        ns[name] = eval(expr, {"__builtins__": {}}, ns)  # noqa: S307
    return ns[program.root], [eval(g, {"__builtins__": {}}, ns)  # noqa: S307
                              for g in program.grads]
