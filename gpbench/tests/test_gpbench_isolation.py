"""The harness loads nothing of JAX or the JAX package; the reference
loads nothing of the program; the measuring entry fails without a card."""
import json
import os
import subprocess
import sys

import gpbench_tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "gaussianprocessfundamentals_tpu"}

PROBE = """
import sys, json
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level_modules(imports: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(gpbench_tiny.ROOT),
                                            imports=imports)],
        capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_import_closure_has_no_jax():
    mods = _top_level_modules(
        "import gpbench.run, gpbench.calibrate\n"
        "from gpbench.lib import cell, check, faults, instrument, readers, "
        "spec, system, trace, traffic, work\n"
        "from gpbench.traffic.kinds import fit, posterior\n"
        "from gpbench.data import trend, mauna\n"
        "import gaussianprocessfundamentals_tpu_torch\n"
        "from gpbench.lib import spec as s\n"
        "for m in s.benchmark()['per_layer']: s.metric_reader(m['name'])\n")
    assert "gaussianprocessfundamentals_tpu_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(
        "from gpbench.reference import gp, leaves\n"
        "import pkgutil\n"
        "for m in pkgutil.iter_modules(leaves.__path__): leaves.leaf(m.name)\n")
    assert not mods & (FORBIDDEN | {"gaussianprocessfundamentals_tpu_torch"})


def test_measuring_entry_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, str(gpbench_tiny.ROOT / "gpbench" / "run.py"),
         "--workload", "se100k-fit", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "correct" not in out.stdout
