"""Closed loop: the mix's ``clients`` each send their next request when the
last one has returned, from one pool of requests in the seed's order.

A request is timed from when it was sent.  The window closes after
``--seconds``; requests still in flight then finish (up to ``GRACE_S``)
and are judged, but only those completed inside the window count toward
a rate.
"""

from __future__ import annotations

import threading
import time

from benchmark import workload_gen
from benchmark.serving import Serving

GRACE_S = 60.0


class Driver(Serving):
    def window(self, tracer):
        run = self.run
        pool = workload_gen.request_pool(run.mix, run.seed, run.mix["pool"])
        taken = [0]
        lock = threading.Lock()
        run.t0 = t0 = time.perf_counter()
        run.window_s = run.seconds
        t_end = t0 + run.seconds

        def client():
            while time.perf_counter() < t_end:
                with lock:
                    body = pool[taken[0] % len(pool)]
                    taken[0] += 1
                self.request(body, time.perf_counter())

        threads = [threading.Thread(target=client, daemon=True) for _ in range(run.mix["clients"])]
        for th in threads:
            th.start()
        tracer.wait_until(t_end)
        tracer.stop()
        for th in threads:
            th.join(timeout=max(0.0, t_end + GRACE_S - time.perf_counter()))
        run.extra["attempted"] = taken[0]
