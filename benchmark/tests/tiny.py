"""Tiny widths for the benchmark's CPU tests: the cells' own files with
the model and the traffic cut down, run through ``run.execute`` on the CPU."""

from __future__ import annotations

import time

# fp32 on the CPU: the tests hold the harness's logic, not bf16's rounding
TINY_MODEL = {
    "n_feats": 8, "spk_emb_dim": 8, "compute_dtype": "float32",
    "encoder": {"n_feats": 8, "n_channels": 16, "filter_channels": 32, "n_heads": 2, "n_layers": 2,
                "kernel_size": 3, "prenet_kernel_size": 3, "prenet_layers": 2, "rope_max_len": 256},
    "duration_predictor": {"filter_channels": 16, "kernel_size": 3, "n_layers": 2},
    "decoder": {"channels": [32, 32], "attention_head_dim": 8, "n_blocks": 1, "num_mid_blocks": 1,
                "num_heads": 2},
}
TINY_VOCOS = {"input_channels": 8, "dim": 32, "intermediate_dim": 64, "num_layers": 1,
              "compute_dtype": "float32"}
SERVE_MIX = {"ids": {"median": 10, "sigma": 0.5, "min": 3, "max": 30}, "judge": {"requests": 3}, "clients": 2,
             "rate_per_s": 3.0}
TRAIN_MIX = {"corpus": {"utterances": 24, "median_frames": 30, "sigma": 0.4, "min_frames": 10, "max_frames": 60}}


def overrides(cell: str) -> dict:
    from benchmark import harness

    mix = harness.mix(harness.cell(cell)["traffic"])
    over_mix = dict(TRAIN_MIX if mix["driver"] == "train_loop" else SERVE_MIX)
    if "clients" not in mix:
        over_mix.pop("clients", None)
    if "rate_per_s" not in mix:
        over_mix.pop("rate_per_s", None)
    return {"config": {"model": TINY_MODEL, "vocos": TINY_VOCOS, "training": {"max_frames_per_batch": 300}},
            "mix": over_mix}


def run(cell: str, seed: int = 7, seconds: float = 2.0, trace: bool = False, fault=None, control=False):
    """(result, Run, forbidden modules loaded) of one tiny run on the CPU."""
    import torch

    from benchmark.run import execute

    torch.set_num_threads(1)
    return execute(cell, seed, seconds, trace, device="cpu", overrides=overrides(cell), fault=fault,
                   control=control, process_start=time.perf_counter())
