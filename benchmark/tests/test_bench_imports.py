"""Nothing a run imports is JAX or the JAX package: the check compares
each module's top-level name whole, since the port's name begins with the
JAX package's."""

import subprocess
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_are_compared_whole():
    mods = ["matcha_tpu_torch", "matcha_tpu_torch.ops.attention", "numpy", "jaxtyping", "toolsy",
            "matcha_tpu", "matcha_tpu.models", "jax", "jaxlib.xla_client", "flax.linen", "tools.x"]
    assert harness.forbidden_modules(mods) == ["flax.linen", "jax", "jaxlib.xla_client", "matcha_tpu",
                                               "matcha_tpu.models", "tools.x"]


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests import tiny\n"
            "res, run, loaded = tiny.run('v20-serve-single', seconds=1.0)\n"
            "from benchmark import harness\n"
            "print('LOADED', harness.forbidden_modules(sys.modules))\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT), env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "benchmark" / ".work"),
                                             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_the_harness_sources_import_no_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in harness.FORBIDDEN_MODULES, (path, line)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] != "matcha_tpu_torch", (path, line)
