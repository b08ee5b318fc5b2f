"""Analytic FLOP of a DiT step on each real utterance of the window at its own length (``flops_f5.py``), over the window and the bf16 peak, in %."""

from benchmark import flops_f5
from benchmark.flops import as_config
from benchmark.harness import PEAK_BF16_FLOPS


def read(run):
    if not run.steps:
        return None
    cfg = as_config(run.cfg["model"])
    total = sum(flops_f5.train_step_flops(cfg, 1, int(n)) for s in run.steps for n in s["y_lengths"][s["real"]])
    return 100.0 * total / run.window_s / PEAK_BF16_FLOPS
