"""The ``f5-train`` cell at tiny widths on the CPU, the harness's look for a
chip skipped: a run is correct, the two broken steps and the fp8 control
are not, every new reader reads, and the frozen FLOP count against a
count by hand."""

from __future__ import annotations

import time
import types

import numpy as np
import pytest

from benchmark import flops, flops_f5, harness

CELL = "f5-train"
TINY_DIT = {"n_feats": 8, "dim": 64, "depth": 2, "heads": 4, "dim_head": 16, "text_dim": 32, "conv_layers": 2,
            "compute_dtype": "float32"}
TINY_MIX = {"corpus": {"utterances": 24, "median_frames": 30, "sigma": 0.4, "min_frames": 10, "max_frames": 60,
                       "ids_per_frame": 0.15}}
NEW_METRICS = ("mfu.f5train", "attn_share.f5train", "kernels_roofline.f5train", "device_idle_share.f5train",
               "peak_mem_gib.f5train", "pad_share.f5train", "batch_wait_ms.f5train")


def tiny_run(seed: int = 7, seconds: float = 2.0, trace: bool = False, fault=None, control=False):
    import torch

    from benchmark.run import execute

    torch.set_num_threads(1)
    over = {"config": {"model": TINY_DIT, "training": {"max_frames_per_batch": 300}}, "mix": TINY_MIX}
    return execute(CELL, seed, seconds, trace, device="cpu", overrides=over, fault=fault, control=control,
                   process_start=time.perf_counter())


def test_a_tiny_run_is_correct():
    result, run, loaded = tiny_run(seed=2**31 + 11)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert result["attempted"] > 0 and not loaded
    assert len(run.extra["drops"]) == 3


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(fault):
    result, _, _ = tiny_run(fault=fault)
    assert not result["correct"], result["checks"]


def test_the_fp8_control_is_not_correct():
    result, run, _ = tiny_run(control=True)
    assert result["correct"], result["checks"]
    limits = harness.cell(CELL)["limits"]
    assert any(run.extra["control"][k] > limits[k] for k in run.extra["control"]), run.extra["control"]


def test_every_new_reader_reads():
    """On a traced tiny run, the readers of the window's steps and of the
    slice's device time; the kernel readers and the memory peak on a
    record of a card's run (the CPU launches no kernel)."""
    import torch

    result, run, _ = tiny_run(seconds=3.0, trace=True)
    assert {"mfu.f5train", "device_idle_share.f5train", "pad_share.f5train",
            "batch_wait_ms.f5train"} <= set(result["metrics"])
    assert set(result["metrics"]) <= set(NEW_METRICS)
    mask = torch.ones((2, 128), dtype=torch.uint8)
    run.traced = {"busy_s": 1.0, "window_s": 2.0,
                  "launches": [("fwd", (2, 16, 128, 64), "bfloat16", True, mask),
                               ("dkv", (2, 16, 128, 64), "bfloat16", False, mask),
                               ("dq", (2, 16, 128, 64), "bfloat16", False, mask)],
                  "kernels": {"masked_attention_fwd_bf16": {"s": 0.1, "count": 1},
                              "attn_bwd_dkv_kernel": {"s": 0.15, "count": 1},
                              "attn_bwd_dq_kernel": {"s": 0.05, "count": 1}, "gemm": {"s": 0.7, "count": 9}}}
    run.extra["peak_mem_window_bytes"] = 3 * 2**30
    read = {m: harness.reader(m)(run) for m in NEW_METRICS}
    assert all(v is not None and v >= 0 for v in read.values()), read
    assert read["attn_share.f5train"] == pytest.approx(30.0)
    assert read["peak_mem_gib.f5train"] == pytest.approx(3.0)
    assert 0 < read["kernels_roofline.f5train"] < 100


def test_readers_find_nothing_without_a_slice():
    run = harness.Run(cell=CELL, seed=1, seconds=1.0, trace=False, cfg={}, mix={}, device=None)
    assert harness.reader("attn_share.f5train")(run) is None
    assert harness.reader("mfu.f5train")(run) is None


def test_the_flop_count_by_hand():
    cfg = types.SimpleNamespace(dim=64, text_dim=32, heads=4, dim_head=16, ff_mult=2, conv_layers=2, depth=2,
                                n_feats=8)
    n = 50
    # per frame, forward: (weights, backward products)
    text = 2 * n * (32 * 7 + 32 * 64 + 64 * 32)                     # × 3: weight and input gradients
    inp = 2 * n * ((16 + 32) * 64 + 2 * (64 // 16) * 64 * 31)        # × 3
    block = 2 * n * (3 * 64 * 64 + 64 * 64 + 64 * 128 + 128 * 64)    # × 3
    attn = 2 * (2 * 4 * n * n * 16)                                   # q·kᵀ and p·v, × 3
    rows = 2 * 256 * 64 * 2 + 2 * 64 * 64 * 3 + 2 * (2 * 64 * 6 * 64 * 3) + 2 * 64 * 128 * 3
    out = 2 * n * 64 * 8 * 3
    want = 3 * (2 * text + inp + 2 * block + 2 * attn) + rows + out
    assert flops_f5.train_step_flops(cfg, 1, n) == pytest.approx(want)
    assert flops_f5.train_step_flops(cfg, 3, n) == pytest.approx(3 * want)
    assert flops.step_flops(flops_f5.dit_products(cfg, 1, n)) == flops_f5.train_step_flops(cfg, 1, n)


def test_the_published_widths_cost_what_the_sizing_says():
    """About 1.4–1.5 GFLOP a frame at the mix's token-weighted length."""
    cfg = flops.as_config(harness.config("f5tts-v1-base")["model"])
    per_frame = flops_f5.train_step_flops(cfg, 1, 1100) / 1100
    assert 1.4e9 < per_frame < 1.5e9
    assert np.isfinite(per_frame)
