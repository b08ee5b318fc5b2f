"""On the card: the control and the runs at the cells' own sizes.

These are the chip's commands (``benchmark/README.md``); each skips
without a CUDA card, deciding inside the test."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the benchmark measures the program on a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.spec()["workloads"]])
def test_control_is_not_correct_at_the_cells_size(cell):
    _card()
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload", cell, "--seeds", "5", "6", "7",
                          "--seconds", "10"], cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = harness.cell(cell)["limits"]
    for line in (x for x in out.stdout.splitlines() if x.startswith("{")):
        rec = json.loads(line)
        assert rec["correct"], rec["checks"]
        extra = rec["extra"]
        if "control" in extra:
            assert any(extra["control"][k] > limits[k] for k in extra["control"])
        else:
            assert extra["control_audio_rel_err"] > limits["audio_rel_err"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.spec()["workloads"]])
def test_one_run_at_the_cells_size(cell):
    _card()
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 3),
                          "--seconds", "10", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
