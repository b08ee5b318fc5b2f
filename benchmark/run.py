"""One run of one benchmark cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s`` from the start of this process): the cell's
driver builds the system under test, makes its weights on the card from
``--seed`` and warms the shapes the cell's traffic uses.  Then the window:
the traffic for ``--seconds``; with ``--trace 1`` a slice of it runs under
``torch.profiler``.  After it: the device's memory peak is read, the
program is freed, and the plain reference judges its outputs.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared, beside its limit); the checks
are also the last lines of standard error.

It exits 2, printing no result, without a CUDA card, and 3 if a module of
the JAX package (or JAX itself) was loaded by the time the window closed.
Every name it needs comes from files: see ``benchmark/README.md``.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TRACE_START_S = 2.0  # the traced slice opens this far into the window
TRACE_SECONDS = 4.0  # and lasts this long (or to the window's end)


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            overrides: dict | None = None, fault=None, control: bool = False,
            process_start: float | None = None):
    """One run → (result dict, Run).  ``overrides`` (tests): a dict merged
    into the configuration and the mix; ``fault`` and ``control``: see
    ``benchmark/control.py`` and the tests."""
    import torch

    from benchmark import harness

    # TensorBoard, where installed, can pull in TensorFlow and JAX: the
    # trainer's metrics sink then writes its JSONL file alone
    sys.modules.setdefault("torch.utils.tensorboard", None)
    start = PROCESS_START if process_start is None else process_start
    bench = harness.spec()
    cell = harness.cell(cell_name)
    cfg, mix = harness.config(cell["config"]), harness.mix(cell["traffic"])
    if overrides:
        cfg = _merge(cfg, overrides.get("config", {}))
        mix = _merge(mix, overrides.get("mix", {}))
    run = harness.Run(cell=cell_name, seed=seed, seconds=seconds, trace=trace, cfg=cfg, mix=mix,
                      device=torch.device(device))
    run.extra["limits"] = cell["limits"]
    if run.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    driver = harness.driver(mix["driver"]).Driver(run, fault=fault)
    driver.setup()
    run.setup_s = time.perf_counter() - start
    tracer = harness.Tracer(run, TRACE_START_S, min(TRACE_SECONDS, max(0.5, seconds - TRACE_START_S)))
    driver.window(tracer)
    tracer.stop()
    loaded = harness.forbidden_modules(sys.modules)
    device_info = harness.device_info(run)
    metrics = harness.read_metrics(run, harness.cell_metrics(bench, cell_name, trace))
    driver.release()
    driver.judge(control=control)
    failed = run.extra.get("failed", 0)
    result = {
        "correct": all(c["value"] <= c["limit"] for c in run.checks.values()),
        "attempted": run.extra.get("attempted", len(run.requests)),
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if trace and run.traced is not None:
        result["breakdown"] = run.traced["breakdown"]
    result["checks"] = run.checks
    return result, run, loaded


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    need = next(w for w in harness.spec()["workloads"] if w["name"] == args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: needs {need} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, _, loaded = execute(args.workload, args.seed, args.seconds, bool(args.trace))
    if loaded:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
