"""Profiling / tracing helpers (``torch.profiler`` surface).

The port's counterpart of ``matcha_tpu/utils/profiling.py``:

  * ``trace(logdir)`` — context manager around ``torch.profiler``: CPU
    activity, plus CUDA activity where a card is present; on exit the
    timeline is written into ``logdir`` as a Chrome trace, which
    ``utils/trace_analysis.py`` reads and chrome://tracing or Perfetto show
  * ``annotate(name)`` — a named range in the trace
  * ``StageTimer`` — per-stage wall-time accounting with RTF, the same
    per-synthesis numbers the reference prints (cli.py:122-123)
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; write ``<logdir>/trace_<pid>_<ns>.json``.  On the
    card the block's device work is waited for before the profiler stops,
    so every kernel it launched lands in the trace."""
    on_card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    return record_function(name)


class StageTimer:
    """Accumulates wall time per named stage; prints an RTF-style report."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, audio_seconds: float | None = None) -> str:
        lines = []
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            line = f"{name:>20}: {t*1000:8.1f} ms  x{self.counts[name]}"
            if audio_seconds:
                line += f"  (RTF {t/audio_seconds:.4f})"
            lines.append(line)
        if audio_seconds:
            lines.append(f"{'TOTAL':>20}: {total*1000:8.1f} ms  (RTF {total/audio_seconds:.4f})")
        return "\n".join(lines)
