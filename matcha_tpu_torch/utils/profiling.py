"""Profiling / tracing helpers (``torch.profiler`` surface).

The port's counterpart of ``matcha_tpu/utils/profiling.py``:

  * ``trace(logdir)`` — context manager around ``torch.profiler``: CPU
    activity, plus CUDA activity where a card is present; on exit the
    timeline is written into ``logdir`` as a Chrome trace, which
    ``utils/trace_analysis.py`` reads and chrome://tracing or Perfetto show
  * ``annotate(name)`` — the program's span: a named range in the trace
    while a torch profiler records on the calling thread, and nothing
    otherwise.  Program span names start with ``matcha/``; the spans of
    the training path are read by ``trace_analysis.span_stats``
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_NO_SPAN = contextlib.nullcontext()


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
    """A ``record_function`` range named ``name`` while a profiler records
    on this thread (on the trace's clock, inside the range that encloses it
    on the thread); otherwise one shared null context, for the cost of one
    call.  The profiler's state is per thread: a thread started from Python
    (the trainer's prefetch worker) records nothing, while the autograd
    engine's threads take the state of the thread that runs the backward."""
    return record_function(name) if torch._C._autograd._profiler_enabled() else _NO_SPAN
