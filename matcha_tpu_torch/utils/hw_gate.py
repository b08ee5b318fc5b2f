"""The port's hardware gate: run the card's test tiers and write one JSON
artifact that can be read without running the card again.

Counterpart of ``tools/hw_gate.py``.  Two tiers, each a pytest subprocess
on the card (``-m cuda``, without ``tests/conftest.py``, which imports
JAX):

  1. tests/test_torch_cuda_kernels.py  every hand-written kernel against its
                                       plain PyTorch version
  2. tests/test_torch_cuda_e2e.py      the full production graph on the
                                       card against the JAX package's CPU
                                       fp32 oracle (tests/data/
                                       torch_e2e_oracle.npz)

It collects the readings the second tier prints (``[card-e2e] ...``
lines), the pass counts and the card's ``nvidia-smi`` name and power
limit:

    python -m matcha_tpu_torch.utils.hw_gate --out hw_gate.json

Exits 1 if a tier fails, times out, has no passing test or skips one (the
artifact is written in every case); raises where there is no card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]

TIERS = (
    ("cuda_kernels", ["tests/test_torch_cuda_kernels.py"]),
    ("cuda_e2e", ["tests/test_torch_cuda_e2e.py"]),
)

# "[card-e2e] two-stage bf16 vs fp32 oracle: MCD 0.1790 dB"
# "[card-e2e] durations bf16 vs fp32 oracle: max_abs_diff 0, fraction_differ 0"
_LINE_RE = re.compile(r"^\[card-e2e\]\s+(.+?):\s+(.+)$", re.M)
_MCD_RE = re.compile(r"^MCD ([-\d.e+]+) dB$")
_READING_RE = re.compile(r"^(\S+) (\S+)$")
_COUNT_RE = re.compile(r"(\d+) (passed|failed|skipped|errors?)\b")


def parse_readings(out: str) -> tuple[dict, dict]:
    """The ``[card-e2e]`` lines → ({what: MCD dB}, {what: {name: value}})."""
    mcd, other = {}, {}
    for what, rest in _LINE_RE.findall(out):
        for part in rest.split(", "):
            m = _MCD_RE.match(part.strip())
            if m:
                mcd[what] = float(m.group(1))
                continue
            m = _READING_RE.match(part.strip())
            if m:
                other.setdefault(what, {})[m.group(1)] = float(m.group(2))
    return mcd, other


def parse_counts(out: str) -> dict[str, int]:
    """pytest's summary line → {passed, failed, skipped, errors}."""
    counts = {"passed": 0, "failed": 0, "skipped": 0, "errors": 0}
    summary = [line for line in out.splitlines() if _COUNT_RE.search(line)]
    for n, kind in _COUNT_RE.findall(summary[-1] if summary else ""):
        counts["errors" if kind.startswith("error") else kind] = int(n)
    return counts


def _text(stream) -> str:
    """A captured stream as text (``TimeoutExpired`` may hold bytes or None)."""
    if stream is None:
        return ""
    return stream.decode(errors="replace") if isinstance(stream, bytes) else stream


def run_tier(name: str, paths: list[str], timeout_s: float) -> dict:
    """One tier as a pytest subprocess.  A tier that runs past ``timeout_s``
    is killed and recorded as failed (``returncode`` None, ``timed_out``),
    with the tail of what it printed until then."""
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-s", "-m", "cuda", *paths],
            capture_output=True, text=True, cwd=str(REPO), timeout=timeout_s,
        )
        returncode, timed_out, out = proc.returncode, False, proc.stdout + proc.stderr
    except subprocess.TimeoutExpired as exc:
        returncode, timed_out, out = None, True, _text(exc.stdout) + _text(exc.stderr)
    counts = parse_counts(out)
    tier = {"paths": paths, "returncode": returncode, "timed_out": timed_out, **counts,
            "ok": returncode == 0 and counts["passed"] > 0 and counts["skipped"] == 0,
            "wall_s": round(time.time() - t0, 1)}
    mcd, other = parse_readings(out)
    if mcd:
        tier["measured_mcd_db"] = mcd
    if other:
        tier["readings"] = other
    if not tier["ok"]:
        tier["tail"] = out[-3000:]
    print(f"[hw-gate] {name}: {'OK' if tier['ok'] else 'FAIL'} ({tier['wall_s']}s, {counts['passed']} passed)",
          file=sys.stderr)
    return tier


def card() -> dict:
    """The card's name (torch) and ``nvidia-smi``'s name and power limit."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the hardware gate runs the card's tiers")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="where to write the JSON artifact")
    ap.add_argument("--timeout", type=float, default=1800.0, help="seconds a tier may take")
    args = ap.parse_args(argv)

    report = {"date": time.strftime("%Y-%m-%d %H:%M:%S"), "device": card(), "tiers": {}}
    for name, paths in TIERS:
        report["tiers"][name] = run_tier(name, paths, args.timeout)
    report["ok"] = all(t["ok"] for t in report["tiers"].values())

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2) + "\n")
    print(json.dumps({"ok": report["ok"], "artifact": str(out)}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
