"""The traced slice, from a ``torch.profiler`` Chrome trace.

The device's work is its kernel, memcpy and memset events; kernels on
several streams overlap, so the busy time is the union of their intervals
(the rule of the program's ``utils/trace_analysis.device_stats``, copied).
Each idle gap between device events is labelled by the benchmark span that
was open on the host at its middle (the most recently opened one), and the
gaps are summed by label.  Host spans are on ``time.perf_counter_ns``; the
``benchmark.anchor`` annotation, recorded at a known host time, maps them
onto the trace's clock.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def read(path: Path, anchor_ns: int, spans: list, window_s: float) -> dict:
    with open(path) as f:
        obj = json.load(f)
    events = obj.get("traceEvents", []) if isinstance(obj, dict) else obj
    dev, kernels, anchor_us = [], {}, None
    for ev in events:
        if ev.get("ph") != "X" or ev.get("ts") is None:
            continue
        if ev.get("name") == "benchmark.anchor":
            anchor_us = float(ev["ts"])
        if ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        ts, dur = float(ev["ts"]), float(ev.get("dur") or 0.0)
        dev.append((ts, ts + dur))
        k = kernels.setdefault(ev.get("name", "?"), [0.0, 0])
        k[0] += dur / 1e6
        k[1] += 1
    dev.sort()
    busy, end, gaps = 0.0, None, []
    for s, e in dev:
        if end is None:
            busy += e - s
            end = e
            continue
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    if anchor_us is not None and dev:  # the slice's head and tail are idle too
        gaps = [(anchor_us, dev[0][0])] + gaps + [(end, anchor_us + window_s * 1e6)]
        gaps = [(s, e) for s, e in gaps if e > s]
    labels = _label(gaps, anchor_us, anchor_ns, spans)
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "busy_s": busy / 1e6,
        "device_events": len(dev),
        "kernels": {name: {"s": v[0], "count": v[1]} for name, v in kernels.items()},
        "breakdown": {
            "device_ops": [[name[:160], v[0]] for name, v in top_ops],
            "idle_gaps": sorted(([k, v] for k, v in labels.items()), key=lambda kv: -kv[1])[:TOP],
        },
    }


def _label(gaps, anchor_us, anchor_ns, spans) -> dict:
    """Idle seconds by the host span open at each gap's middle."""
    out: dict[str, float] = {}
    if anchor_us is None:
        for s, e in gaps:
            out["unlabelled"] = out.get("unlabelled", 0.0) + (e - s) / 1e6
        return out
    offset = anchor_us - anchor_ns / 1e3
    ordered = sorted((s / 1e3 + offset, e / 1e3 + offset, name) for s, e, name in spans)
    starts = [sp[0] for sp in ordered]
    for s, e in gaps:
        mid = 0.5 * (s + e)
        label = "no benchmark span"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            if ordered[j][1] >= mid:
                label = ordered[j][2]
                break
        out[label] = out.get(label, 0.0) + (e - s) / 1e6
    return out
