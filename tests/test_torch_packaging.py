"""An installed (non-editable) copy of the port can build its kernels: the
package data of ``pyproject.toml`` ships every CUDA source and header
under ``csrc/``, and every header a source includes is shipped."""
import fnmatch
import re
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = "gaussianprocessfundamentals_tpu_torch"


def _shipped_globs():
    with open(ROOT / "pyproject.toml", "rb") as f:
        cfg = tomllib.load(f)
    return cfg["tool"]["setuptools"]["package-data"][PKG]


def _shipped(rel: str) -> bool:
    return any(fnmatch.fnmatch(rel, g) for g in _shipped_globs())


def test_every_cuda_source_and_header_is_shipped():
    csrc = ROOT / PKG / "csrc"
    files = sorted(p for ext in ("*.cu", "*.cuh") for p in csrc.glob(ext))
    assert any(p.suffix == ".cuh" for p in files)
    missing = [p.name for p in files if not _shipped(f"csrc/{p.name}")]
    assert not missing, f"not in package-data: {missing}"


def test_every_included_header_resolves_to_a_shipped_file():
    csrc = ROOT / PKG / "csrc"
    for src in sorted(csrc.glob("*.cu*")):
        for h in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert (csrc / h).is_file(), f"{src.name} includes missing {h}"
            assert _shipped(f"csrc/{h}"), f"{src.name}: {h} is not shipped"
