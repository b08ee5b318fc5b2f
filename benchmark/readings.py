"""Arithmetic shared by the metric readers in ``metrics/``: each reader is
a file of its own that names one of these (or its own function), so a new
metric is a new file.  Every reading is taken over the whole window: all
its requests, group calls or steps, and all its time."""

from __future__ import annotations

import numpy as np

from benchmark import flops, roofline
from benchmark.harness import PEAK_BF16_FLOPS, percentile

MISSING_AFTER_S = 60.0  # a request that never returned counts as this late, past the window


def window_requests(run) -> list[dict]:
    return [r for r in run.requests if run.t0 <= r["due"] <= run.t0 + run.window_s]


def latency_ms(run, q: float) -> float | None:
    """The q-th percentile of (return − due) over every request due in the
    window; one that failed or never returned counts as missing every limit."""
    reqs = window_requests(run)
    attempted = run.extra.get("attempted", len(reqs))
    worst = (run.window_s + MISSING_AFTER_S) * 1e3
    lat = [(r["done"] - r["due"]) * 1e3 if r["ok"] else worst for r in reqs]
    lat += [worst] * max(0, attempted - len(reqs))
    return percentile(lat, q) if lat else None


def completed(run) -> list[dict]:
    return [r for r in run.requests if r["ok"] and r["done"] <= run.t0 + run.window_s]


def audio_s_per_s(run) -> float | None:
    if not run.requests:
        return None
    return sum(r["audio_s"] for r in completed(run)) / run.window_s


def window_groups(run) -> list[tuple]:
    return [g for g in run.group_calls if run.t0 <= g[0] <= run.t0 + run.window_s]


def group_rows(run) -> float | None:
    groups = window_groups(run)
    return float(np.mean([g[2] for g in groups])) if groups else None


def group_call_ms(run, q: float) -> float | None:
    groups = window_groups(run)
    return percentile([(g[1] - g[0]) * 1e3 for g in groups], q) if groups else None


def idle_share(run) -> float | None:
    t = run.traced
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def serve_mfu(run) -> float | None:
    """Σ FLOP of each request completed in the window at its own lengths
    (one row, its ids, its frames), over the window and the bf16 peak."""
    done = completed(run)
    if not done:
        return None
    m, v = flops.as_config(run.cfg["model"]), flops.as_config(run.cfg["vocos"])
    s = run.cfg["serving"]
    hop = run.cfg["vocos"]["hop_length"]
    total = 0.0
    for r in done:
        coarse = round(r["audio_s"] * run.cfg["vocos"]["sample_rate"] / hop) + 1
        total += flops.synthesis_flops(m, v, 1, r["n"], 2 * coarse, s["n_timesteps"], s["solver"])
    return 100.0 * total / run.window_s / PEAK_BF16_FLOPS


def train_frames_per_s(run) -> float | None:
    if not run.steps:
        return None
    return sum(float(s["y_lengths"][s["real"]].sum()) for s in run.steps) / run.window_s


def train_mfu(run) -> float | None:
    """Σ FLOP of a training step on each real utterance at its own lengths,
    over the window and the bf16 peak."""
    if not run.steps:
        return None
    m = flops.as_config(run.cfg["model"])
    total = sum(flops.train_step_flops(m, 1, int(x), int(y))
                for s in run.steps for x, y in zip(s["x_lengths"][s["real"]], s["y_lengths"][s["real"]]))
    return 100.0 * total / run.window_s / PEAK_BF16_FLOPS


def pad_share(run) -> float | None:
    if not run.steps:
        return None
    real = sum(float(s["y_lengths"][s["real"]].sum()) for s in run.steps)
    return 100.0 * (1.0 - real / sum(s["rows"] * s["ty"] for s in run.steps))


def batch_wait_ms(run) -> float | None:
    return 1e3 * float(np.mean([s["wait_s"] for s in run.steps])) if run.steps else None


def peak_mem_gib(run) -> float | None:
    b = run.extra.get("peak_mem_window_bytes")
    return None if b is None else b / 2**30


def attention_roofline(run) -> float | None:
    return roofline.share(run.traced, ("fwd",))


def training_kernels_roofline(run) -> float | None:
    return roofline.share(run.traced, ("fwd", "dkv", "dq", "mas"))
