"""The port stands alone: no JAX, no flax/optax, nothing of matcha_tpu/tools.

An AST scan of every module of ``matcha_tpu_torch/`` and of
``chip_smoke.py`` (imports anywhere in a file, lazy ones included); and of
the model layer (``models/``, ``vocoder/``) for reads of the device and
helpers borrowed from another model.
"""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "matcha_tpu", "tools")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _port_files():
    files = sorted((ROOT / "matcha_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_scan_covers_the_port():
    files = _port_files()
    assert (ROOT / "chip_smoke.py").exists()
    assert any(f.name == "inference.py" for f in files)


@pytest.mark.parametrize("module", ["bench.py", "utils/flops.py", "utils/profile_stage_b.py",
                                    "utils/profile_step.py", "utils/ab_fast_solvers.py",
                                    "utils/ab_stage_b_levers.py", "utils/live_serving_ab.py",
                                    "utils/measure_progressive_boot.py"])
def test_scan_covers_the_measuring_entry_points(module):
    """The benchmark, the profilers and the A/B and live-serving tools run
    on the card's machine, which has no JAX: the scan holds them too."""
    assert ROOT / "matcha_tpu_torch" / module in _port_files()


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _model_layer_files():
    port = ROOT / "matcha_tpu_torch"
    return sorted((port / "models").rglob("*.py")) + sorted((port / "vocoder").rglob("*.py"))


def _names_a_device(node) -> bool:
    return (isinstance(node, ast.Name) and node.id == "device") or (
        isinstance(node, ast.Attribute) and node.attr == "device")


@pytest.mark.parametrize("path", _model_layer_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_the_model_layer_leaves_the_device_to_the_ops(path):
    """A model or the vocoder never picks its path by device (``ops/`` alone
    chooses between a kernel and its plain version), and takes the helpers
    it shares from ``models/layers.py``: from ``models.matcha`` and
    ``models.decoder`` it imports a model class, nothing else."""
    tree = ast.parse(path.read_text(), filename=str(path))
    reads = [ast.unparse(node) for node in ast.walk(tree) if isinstance(node, ast.Attribute) and (
        node.attr == "is_cuda" or (node.attr == "type" and _names_a_device(node.value)))]
    assert not reads, f"{path.relative_to(ROOT)} reads {reads}"
    models = "matcha_tpu_torch.models"
    borrowed = [f"{node.module}.{alias.name}" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
                for alias in node.names
                if (node.module in (f"{models}.matcha", f"{models}.decoder") and not alias.name[0].isupper())
                or (node.module == models and alias.name in ("matcha", "decoder"))]
    borrowed += [alias.name for node in ast.walk(tree) if isinstance(node, ast.Import) for alias in node.names
                 if alias.name in (f"{models}.matcha", f"{models}.decoder")]
    assert not borrowed, f"{path.relative_to(ROOT)} borrows {borrowed}"


def test_synthesizer_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from matcha_tpu_torch.inference import MatchaSynthesizer
    from matcha_tpu_torch.models.config import tiny_config

    with pytest.raises(RuntimeError, match="CUDA"):
        MatchaSynthesizer(tiny_config(), params={})


def test_card_e2e_tier_imports_no_jax():
    """The card tier runs where there is no JAX: it imports neither JAX nor
    the JAX package."""
    path = ROOT / "tests" / "test_torch_cuda_e2e.py"
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"tests/test_torch_cuda_e2e.py imports {bad}"
