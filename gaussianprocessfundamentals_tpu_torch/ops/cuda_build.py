"""Build and load the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C entry point. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library under ``csrc/_build/`` on
first use, and loaded with :mod:`ctypes`. The library name carries a hash of
the source and the flags, so an edited source is rebuilt and a stale library
is never loaded. Sources generated at run time (one per kernel expression,
:mod:`.cuda_expr`) are written into ``csrc/_build/`` under a name that is
the hash of their text, then built the same way; :func:`build_concurrently`
runs several builds at once, one ``nvcc`` each. Nothing here runs at import
time: the CPU tests import every module on machines without ``nvcc`` or a
card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


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


def library_path(source: str) -> Path:
    src = CSRC / source
    return BUILD_DIR / f"lib{src.stem}_{_digest(src.read_bytes())}.so"


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
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless an up-to-date library exists."""
    return _compile(CSRC / source, library_path(source))


def build_generated(stem: str, text: str) -> Path:
    """Write a generated source into the build directory and compile it,
    both named by the hash of its text (and the flags)."""
    name = f"{stem}_{_digest(text.encode())}"
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{name}.cu"
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
