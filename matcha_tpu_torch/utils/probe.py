"""Inner-repeat device-time probe: the no-profiler way to split a program's
wall time into device compute and fixed per-call overhead.

The port's counterpart of ``matcha_tpu/utils/probe.py``.  There, one jitted
program runs the body ``n`` times back to back with a sequential data
dependency (iteration i's scalar output perturbs iteration i+1's input)
and returns only a scalar.  Here the same chain of ``n`` calls is captured
once as a CUDA graph and timed as one replay: the host launches it with
one call whatever ``n`` is, so fixed costs (the launch, the synchronize)
are the same for n=1 and n=k, and

    device_ms ~= (wall_k - wall_1) / (k - 1)
    fixed_ms  ~= wall_1 - device_ms

Timing eager calls instead would measure the host's launches, not the
device.  A ``fn`` that cannot be captured (a host synchronisation, a
data-dependent shape) raises with the reason; the probe never falls back
to eager calls on the card.  Graph capture keeps each argument's address,
so ``args`` are the static buffers the graph reads.  A launch counter
counts a kernel once at capture, not once per replay: do not probe inside
a window whose counts are read.

On the CPU (no argument on the card) the chain runs eagerly: the plain
version, for the tests.

Probe-honesty rule (from the JAX package): the per-iteration scalar must
consume EVERY output of the program in full (``out.float().sum()``), so
that a program which skips work cannot look faster than it is.
"""

from __future__ import annotations

import statistics
import time

import torch


def _device(args) -> torch.device:
    for a in args:
        if torch.is_tensor(a) and a.device.type == "cuda":
            return a.device
    return torch.device("cpu")


def _chain(fn, args, n: int, acc: torch.Tensor) -> torch.Tensor:
    for _ in range(n):
        acc = fn(acc, *args)
    return acc


def _capture(fn, args, n: int, acc: torch.Tensor):
    graph = torch.cuda.CUDAGraph()
    generator = torch.cuda.default_generators[acc.device.index]
    saved = generator.clone_state()
    try:
        with torch.cuda.graph(graph):
            out = _chain(fn, args, n, acc)
    except RuntimeError as exc:
        # a capture that fails half-way leaves the device's default generator
        # marked as capturing, which breaks every later draw: give it back an
        # uncaptured copy of its state
        generator.graphsafe_set_state(saved)
        raise RuntimeError(f"inner_repeat: fn cannot be captured in a CUDA graph: {exc}") from exc
    return graph, out


def inner_repeat(fn, *args, k: int = 4, reps: int = 5) -> dict:
    """Median-timed ``{"device_ms", "fixed_ms"}`` for ``fn``.

    ``fn(acc, *args)`` must consume a 0-d float32 tensor ``acc`` (perturbing
    its inputs with it) and return one that sums every output in full.
    """
    device = _device(args)
    acc0 = torch.zeros((), dtype=torch.float32, device=device)
    if device.type == "cuda":
        # warm-up on a side stream (library plans, allocator pools), as
        # CUDA graph capture asks
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            _chain(fn, args, 2, acc0)
        torch.cuda.current_stream(device).wait_stream(side)
        graphs = {n: _capture(fn, args, n, acc0) for n in (1, k)}

        def run(n):
            graphs[n][0].replay()
            torch.cuda.synchronize(device)
    else:
        def run(n):
            _chain(fn, args, n, acc0)

    def timed(n):
        run(n)  # warm-up
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run(n)
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    w1 = timed(1)
    wk = timed(k)
    dev = (wk - w1) / (k - 1)
    return {"device_ms": dev * 1e3, "fixed_ms": (w1 - dev) * 1e3}
