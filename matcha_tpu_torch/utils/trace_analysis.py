"""Device time from ``torch.profiler`` Chrome traces.

The port's counterpart of ``matcha_tpu/utils/trace_analysis.py``: splits a
traced region's wall time into the time the card was busy and everything
else (host, launches, waits), the breakdown the RTF story needs.

Usage:
    with utils.profiling.trace(logdir):
        ... run N iterations ...
    stats = device_stats(logdir)
    # stats["device_busy_ms"]: the time the card executed anything

or ``python -m matcha_tpu_torch.utils.trace_analysis <logdir>``.

Every ``*.json`` trace under ``logdir`` is read (``trace`` writes one per
block; ``torch.profiler``'s ``export_chrome_trace`` output).  The device's
work is its kernel, memcpy and memset events (categories ``kernel``,
``gpu_memcpy``, ``gpu_memset``).  Kernels on several streams overlap, so
the busy time is the length of the union of those intervals, not their sum.
"""

from __future__ import annotations

import glob
import json
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _find_traces(logdir: str | Path) -> list[str]:
    root = Path(logdir)
    return sorted(glob.glob(str(root / "**" / "*.json"), recursive=True))


def _trace_events(path: str) -> list[dict]:
    with open(path) as f:
        obj = json.load(f)
    return obj.get("traceEvents", []) if isinstance(obj, dict) else obj


def _union_ms(spans) -> float:
    """Length of the union of ``(start_us, end_us)`` intervals, in ms."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy / 1e3


def device_stats(logdir: str | Path) -> dict:
    """Aggregate device-side busy time from every trace under ``logdir``.

    Returns a dict with:
      device_busy_ms   — union of kernel, memcpy and memset intervals
      modules          — {kernel or copy name: {"ms": total, "count": n}},
                         the most time first
      wall_span_ms     — first-to-last event span across the traces (the
                         traced region's wall time, host included)
      device_planes    — the device processes' labels in the trace ("GPU 0")
      device_events    — the number of kernel, memcpy and memset events
    """
    traces = _find_traces(logdir)
    if not traces:
        raise FileNotFoundError(f"no *.json trace under {logdir}")
    events: list[dict] = []
    for path in traces:
        events.extend(_trace_events(path))

    # a device's process is named after the program, and labelled "GPU <i>"
    proc_names = {ev.get("pid"): ev.get("args", {}).get("name", "")
                  for ev in events if ev.get("ph") == "M" and ev.get("name") == "process_name"}
    proc_names.update({ev.get("pid"): ev.get("args", {}).get("labels", "")
                       for ev in events if ev.get("ph") == "M" and ev.get("name") == "process_labels"})
    spans, device_pids, modules = [], set(), {}
    t_min, t_max = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X" or ev.get("ts") is None:
            continue
        ts, dur = float(ev["ts"]), float(ev.get("dur") or 0.0)
        t_min, t_max = min(t_min, ts), max(t_max, ts + dur)
        if ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        spans.append((ts, ts + dur))
        device_pids.add(ev.get("pid"))
        m = modules.setdefault(ev.get("name", "?"), {"ms": 0.0, "count": 0})
        m["ms"] += dur / 1e3
        m["count"] += 1

    return {
        "device_busy_ms": _union_ms(spans),
        "modules": dict(sorted(modules.items(), key=lambda kv: -kv[1]["ms"])),
        "wall_span_ms": (t_max - t_min) / 1e3 if t_max > t_min else 0.0,
        "device_planes": sorted(str(proc_names.get(p, p)) for p in device_pids),
        "device_events": len(spans),
    }


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("logdir")
    args = parser.parse_args(argv)
    print(json.dumps(device_stats(args.logdir), indent=2))


if __name__ == "__main__":
    main()
