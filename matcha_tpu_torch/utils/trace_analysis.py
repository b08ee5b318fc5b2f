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

``span_stats(logdir)`` splits the same traces by the program's spans
(``utils/profiling.annotate``, names starting ``matcha/``): each span's
wall time and device events a training step, and the idle time by the span
open on the step's thread.

Every ``*.json`` trace under ``logdir`` is read (``trace`` writes one per
block; ``torch.profiler``'s ``export_chrome_trace`` output).  The device's
work is its kernel, memcpy and memset events (categories ``kernel``,
``gpu_memcpy``, ``gpu_memset``).  Kernels on several streams overlap, so
the busy time is the length of the union of those intervals, not their sum.
"""

from __future__ import annotations

import bisect
import glob
import json
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")  # host calls that launch device events
SPAN_PREFIX = "matcha/"
STEP = "matcha/train.step"
STEP_PHASES = ("matcha/train.forward", "matcha/train.backward", "matcha/train.optimizer",
               "matcha/train.metrics")
NO_SPAN = "no program span"


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


class _Span:
    __slots__ = ("start", "end", "name", "children", "starts", "launches")

    def __init__(self, start: float, end: float, name: str):
        self.start, self.end, self.name = start, end, name
        self.children: list[_Span] = []
        self.starts: list[float] = []
        self.launches = 0

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def innermost(self, t: float) -> _Span | None:
        """The innermost span below this one open at time ``t``, or None."""
        found, node = None, self
        while node.children:
            i = bisect.bisect_right(node.starts, t) - 1
            if i < 0 or node.children[i].end < t:
                break
            found = node = node.children[i]
        return found


def _tree(spans: list[_Span]) -> _Span:
    """One thread's spans under a root that holds them all: a span's parent
    is the innermost span that encloses it (ranges on one thread nest)."""
    root = _Span(float("-inf"), float("inf"), "")
    stack = [root]
    for sp in sorted(spans, key=lambda sp: (sp.start, -sp.end)):
        while stack[-1].end < sp.end:
            stack.pop()
        stack[-1].children.append(sp)
        stack[-1].starts.append(sp.start)
        stack.append(sp)
    return root


def span_stats(logdir: str | Path) -> dict:
    """The training path's program spans in every trace under ``logdir``.

    A device event (kernel, memcpy, memset) belongs to the innermost
    program span open on the thread of the host call that launched it (the
    ``cuda_runtime`` or ``cuda_driver`` event of the same
    ``args.correlation``); where that thread has none open, as the autograd
    engine's threads have not, to the innermost one open at that moment on
    the thread that opened the ``matcha/train.step`` spans (the step's
    thread).  A thread the profiler does not record (the trainer's prefetch
    worker) opens no span, so the worker's batch copies count with the span
    open on the step's thread when they are launched.

    Returns a dict with:
      steps              — the number of ``matcha/train.step`` spans
      per_step           — {span name: {"ms", "launches"}} over the spans
                           inside those steps: wall ms, and the device
                           events of the span and the spans inside it, each
                           summed over the steps and divided by their number
      phases_cover       — {"min", "mean"} over the steps of the share of a
                           step's wall time its four phases (forward,
                           backward, optimizer, metrics) cover; None without
                           a step
      loader_wait_ms     — mean wall ms of the ``matcha/loader.wait`` spans,
                           or None
      idle_gaps_program  — {label: seconds}: the traced region's time with no
                           device event running (device_stats' wall span
                           less its busy time), each gap labelled by the
                           innermost program span open on the step's thread
                           at its middle, or "no program span"
      unassigned_events  — device events under no program span
    """
    traces = _find_traces(logdir)
    if not traces:
        raise FileNotFoundError(f"no *.json trace under {logdir}")
    by_thread: dict[tuple, list[_Span]] = {}
    calls: dict[tuple, tuple] = {}  # (trace, correlation) → (thread, launch µs)
    device: list[tuple] = []
    t_min, t_max = float("inf"), float("-inf")
    for k, path in enumerate(traces):
        for ev in _trace_events(path):
            if ev.get("ph") != "X" or ev.get("ts") is None:
                continue
            ts, dur = float(ev["ts"]), float(ev.get("dur") or 0.0)
            t_min, t_max = min(t_min, ts), max(t_max, ts + dur)
            cat, thread = ev.get("cat"), (ev.get("pid"), ev.get("tid"))
            corr = (ev.get("args") or {}).get("correlation")
            if cat == "user_annotation" and ev.get("name", "").startswith(SPAN_PREFIX):
                by_thread.setdefault(thread, []).append(_Span(ts, ts + dur, ev["name"]))
            elif cat in LAUNCH_CATEGORIES and corr is not None:
                calls[(k, corr)] = (thread, ts)
            elif cat in DEVICE_CATEGORIES:
                device.append((ts, ts + dur, (k, corr)))
    trees = {thread: _tree(spans) for thread, spans in by_thread.items()}
    step_thread = next((th for th, spans in by_thread.items() if any(sp.name == STEP for sp in spans)), None)
    step_tree = trees.get(step_thread, _tree([]))

    unassigned = 0
    for _, _, key in device:
        call = calls.get(key)
        span = None
        if call is not None:
            thread, ts = call
            span = (trees[thread].innermost(ts) if thread in trees else None) or step_tree.innermost(ts)
        if span is None:
            unassigned += 1
        else:
            span.launches += 1

    steps = [sp for sp in step_tree.walk() if sp.name == STEP]
    per_step: dict[str, dict] = {}
    for step in steps:
        for sp in step.walk():
            entry = per_step.setdefault(sp.name, {"ms": 0.0, "launches": 0})
            entry["ms"] += (sp.end - sp.start) / 1e3
            entry["launches"] += sum(s.launches for s in sp.walk())
    for entry in per_step.values():
        entry["ms"] /= len(steps)
        entry["launches"] /= len(steps)
    covers = [sum(c.end - c.start for c in step.children if c.name in STEP_PHASES) / (step.end - step.start)
              for step in steps if step.end > step.start]
    waits = [sp.end - sp.start for spans in by_thread.values() for sp in spans if sp.name == "matcha/loader.wait"]

    idle: dict[str, float] = {}
    end = t_min
    for s, e in sorted((s, e) for s, e, _ in device) + [(t_max, t_max)]:
        if s > end:
            span = step_tree.innermost(0.5 * (s + end))
            label = NO_SPAN if span is None else span.name
            idle[label] = idle.get(label, 0.0) + (s - end) / 1e6
        end = max(end, e)
    return {
        "steps": len(steps),
        "per_step": per_step,
        "phases_cover": {"min": min(covers), "mean": sum(covers) / len(covers)} if covers else None,
        "loader_wait_ms": sum(waits) / len(waits) / 1e3 if waits else None,
        "idle_gaps_program": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
        "unassigned_events": unassigned,
    }


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("logdir")
    args = parser.parse_args(argv)
    print(json.dumps(device_stats(args.logdir), indent=2))


if __name__ == "__main__":
    main()
