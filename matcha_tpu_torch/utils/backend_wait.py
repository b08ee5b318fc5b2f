"""Ride out a transiently unavailable CUDA card.

The port's counterpart of ``matcha_tpu/utils/backend_wait.py``.  A CUDA
context that fails to initialise in a process stays failed for the life of
that process, so the wait probes in fresh CHILD processes and lets the
caller go on in-process once one succeeds.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

PROBE = "import torch; torch.zeros(1, device='cuda'); torch.cuda.synchronize()"


def wait_for_backend(env_var: str = "BENCH_WAIT_BACKEND_S") -> None:
    """Block until a child probe allocates on the card and synchronises.

    Budgeted by ``env_var`` seconds (default 900; 0 disables).  On budget
    exhaustion just return — the caller's normal flow then raises the real
    error for the log.
    """
    budget = float(os.environ.get(env_var, "900"))
    t0 = time.time()
    while budget > 0:
        try:
            probe = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, timeout=180)
            if probe.returncode == 0:
                return
            err = probe.stderr.decode(errors="replace").strip().splitlines()
            err = err[-1] if err else "?"
        except subprocess.TimeoutExpired:
            err = "init probe timed out (backend hang)"
        waited = time.time() - t0
        if waited > budget:
            print(
                f"# backend still unavailable after {waited:.0f}s; "
                "proceeding (will fail with the real error)",
                file=sys.stderr,
            )
            return
        print(f"# backend unavailable ({err}); retrying in 60s", file=sys.stderr)
        time.sleep(60)
