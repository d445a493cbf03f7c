"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C entry point. Its text, with every
``#include "<name>.cuh"`` of a ``csrc/`` header inlined in place
(:func:`expand`), is written into ``csrc/_build/`` under a name that carries
a hash of that text and the flags, compiled there with ``nvcc`` for
``sm_90a`` into a shared library on first use, and loaded with
:mod:`ctypes`. An edited source or header is thus rebuilt, and a stale
library is never loaded. Sources generated at run time (one per kernel
expression, :mod:`.cuda_expr`) are expanded and built the same way;
:func:`build_concurrently` runs several builds at once, one ``nvcc`` each.
``nvcc`` runs with ``-Xptxas -v``: its report of each kernel's registers,
stack and spills is kept beside the library (:func:`ptxas_report`). Nothing
here runs at import time: the CPU tests import every module on machines
without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"

# No --use_fast_math: it replaces expf and division with approximations,
# the same class of silent precision loss as a reduced-precision matmul.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_INCLUDE = re.compile(r'^#include "(\w+\.cuh)"[ \t]*$', re.M)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source on first "
        "use and need the CUDA toolkit"
    )


def _digest(text: bytes) -> str:
    return hashlib.sha1(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]


def expand(text: str, name: str) -> str:
    """``text`` (the file ``name``) with each ``#include "<h>.cuh"`` line
    replaced by the text of ``csrc/<h>.cuh``, itself expanded, between
    ``#line`` markers. What a library is named by and compiled from, so a
    header enters the hash of every source that includes it."""
    def inline(m) -> str:
        header = m.group(1)
        line = text.count("\n", 0, m.end()) + 2
        return (f'#line 1 "{header}"\n'
                + expand((CSRC / header).read_text(), header)
                + f'\n#line {line} "{name}"')
    return _INCLUDE.sub(inline, text)


def _named(stem: str, text: str) -> str:
    return f"{stem}_{_digest(text.encode())}"


def _expanded(source: str) -> str:
    return expand((CSRC / source).read_text(), source)


def generated_library_path(stem: str, text: str) -> Path:
    return BUILD_DIR / f"lib{_named(stem, text)}.so"


def library_path(source: str) -> Path:
    return generated_library_path(Path(source).stem, _expanded(source))


def _compile(src: Path, out: Path) -> Path:
    """nvcc ``src`` into ``out`` unless ``out`` exists."""
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        _log_path(out).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless an up-to-date library exists."""
    return build_generated(Path(source).stem, _expanded(source))


def build_generated(stem: str, text: str) -> Path:
    """Write a complete source (its headers inlined by :func:`expand`) into
    the build directory and compile it, both named by the hash of its text
    (and the flags)."""
    out = generated_library_path(stem, text)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{_named(stem, text)}.cu"
    fd, tmp = tempfile.mkstemp(suffix=".cu", dir=BUILD_DIR)
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, src)
    return _compile(src, out)


def build_concurrently(jobs) -> list:
    """Run zero-argument build callables all at once (each starts one
    ``nvcc``); returns their results in order and raises the first
    failure."""
    jobs = list(jobs)
    if not jobs:
        return []
    with ThreadPoolExecutor(len(jobs)) as pool:
        return list(pool.map(lambda job: job(), jobs))


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build if needed, then load the library (once per process)."""
    return ctypes.CDLL(str(build(source)))


def _log_path(library: Path) -> Path:
    return library.with_suffix(".ptxas.txt")


def ptxas_report(library: Path) -> list:
    """``-Xptxas -v``'s lines of each kernel of a built library: a list of
    dicts with the (mangled) ``name``, ``registers``, ``stack`` bytes and
    ``spill_stores`` / ``spill_loads`` bytes, in the order ptxas printed
    them."""
    out, cur = [], None
    for line in _log_path(library).read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": m.group(1)}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out
