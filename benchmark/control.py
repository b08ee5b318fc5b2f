"""Readings for the limits of ``correct``, on the card, in one process.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 --seconds 10 [--faults]

For each seed: one run of the cell (set-up, a short window at the cell's
own load, the judge), printing the numbers the judge compared (the lower
readings), and the same numbers with the plain reference computed in fp8
in the program's place (the control, the upper readings).  With
``--faults`` (training cells), the judged steps again with the timed path
broken underneath: the optimizer's update skipped (a step that returns its
state unchanged) and half of each batch left out.  One JSON line a run.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.run import execute  # noqa: E402

FAULTS = ("unchanged", "half_batch")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--faults", action="store_true")
    args = parser.parse_args(argv)
    runs = [(s, None) for s in args.seeds]
    if args.faults:
        runs += [(s, f) for f in FAULTS for s in args.seeds[:3]]
    for seed, fault in runs:
        t = time.perf_counter()
        result, run, _ = execute(args.workload, seed, args.seconds, False, fault=fault,
                                 control=fault is None, process_start=time.perf_counter())
        extra = {k: v for k, v in run.extra.items() if k not in ("limits",)}
        print(json.dumps({"seed": seed, "fault": fault, "correct": result["correct"],
                          "checks": {k: c["value"] for k, c in result["checks"].items()},
                          "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                          "extra": extra, "seconds": time.perf_counter() - t}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
