"""Analytic FLOP of a flow-stage step on each real utterance of the window at its own length and its step's streaming draw (``flops_cosy.py``), over the window and the bf16 peak, in %."""

from functools import lru_cache

from benchmark import flops_cosy
from benchmark.flops import as_config
from benchmark.harness import PEAK_BF16_FLOPS


def read(run):
    if not run.steps or any("streaming" not in s for s in run.steps):
        return None
    cfg = as_config(run.cfg["model"])
    row = lru_cache(maxsize=None)(lambda n, streaming: flops_cosy.train_step_flops(cfg, 1, n, streaming))
    total = sum(row(int(n), bool(s["streaming"])) for s in run.steps for n in s["y_lengths"][s["real"]])
    return 100.0 * total / run.window_s / PEAK_BF16_FLOPS
