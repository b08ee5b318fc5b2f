"""Open loop: Poisson arrivals at the mix's fixed rate, each request on a
thread of its own, timed from the moment it was due.

The window is the span of the arrivals (``--seconds``).  After it closes,
every request due in it is waited for, up to ``GRACE_S`` more; one that
never returns counts as failed.  How late the generator sent each request
is recorded (``run.extra["generator_late_ms_max"]``).
"""

from __future__ import annotations

import time

from benchmark import workload_gen
from benchmark.serving import Serving

GRACE_S = 60.0


class Driver(Serving):
    def window(self, tracer):
        run = self.run
        due = workload_gen.arrivals(run.mix, run.seed, run.seconds)
        pool = workload_gen.request_pool(run.mix, run.seed, len(due))
        threads, late = [], 0.0
        run.t0 = t0 = time.perf_counter()
        run.window_s = run.seconds
        for body, d in zip(pool, due):
            tracer.wait_until(t0 + d)
            late = max(late, time.perf_counter() - (t0 + d))
            threads.append(self.spawn(body, t0 + d))
        tracer.wait_until(t0 + run.seconds)
        tracer.stop()
        for th in threads:
            th.join(timeout=max(0.0, t0 + run.seconds + GRACE_S - time.perf_counter()))
        run.extra["generator_late_ms_max"] = 1e3 * late
        run.extra["attempted"] = len(due)
