"""The knee of an open-loop cell: latency at a ladder of fixed rates.

    python3 benchmark/sweep.py --workload v20-serve-poisson --rates 1 2 3 --seconds 20

One set-up, then one window a rate, each with every request waited for.
For each rate: p50, p90 and p95 latency over all requests due in the
window, and the backlog's growth (median latency of the window's last
third over its first third).  The knee is the highest rate whose p95
stays under the limit while the backlog does not grow; a cell's rate is
fixed from it once, in its traffic file.  One JSON line a rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    import torch

    from benchmark import harness, readings

    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args(argv)
    cell = harness.cell(args.workload)
    cfg, mix = harness.config(cell["config"]), harness.mix(cell["traffic"])
    run = harness.Run(cell=args.workload, seed=args.seed, seconds=args.seconds, trace=False, cfg=cfg,
                      mix=mix, device=torch.device("cuda"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = harness.driver(mix["driver"]).Driver(run)
    driver.setup()
    for rate in args.rates:
        run.mix = dict(mix, rate_per_s=rate)
        run.requests.clear()
        run.group_calls.clear()
        driver.window(harness.Tracer(run, 0.0, 0.0))
        reqs = sorted(readings.window_requests(run), key=lambda r: r["due"])
        lat = np.array([(r["done"] - r["due"]) * 1e3 for r in reqs])
        third = max(1, len(lat) // 3)
        print(json.dumps({"rate_per_s": rate, "requests": len(lat),
                          "failed": run.extra["attempted"] - sum(r["ok"] for r in reqs),
                          "p50_ms": readings.latency_ms(run, 50), "p90_ms": readings.latency_ms(run, 90),
                          "p95_ms": readings.latency_ms(run, 95),
                          "backlog_growth": float(np.median(lat[-third:]) / np.median(lat[:third])),
                          "group_rows": readings.group_rows(run)}), flush=True)
        time.sleep(2.0)
    driver.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
