"""The ``cosy-train`` cell at tiny widths on the CPU, the harness's look for a
chip skipped: a run is correct and judges both kinds of step, the two
broken steps, the ignored chunk masks and the fp8 control are not, every
new reader reads, the driver's corpus holds tokens at half the frames, and
the roofline counts only the pairs a chunk keeps."""

from __future__ import annotations

import time

import numpy as np
import pytest

from benchmark import harness

CELL = "cosy-train"
TINY_COSY = {"n_feats": 8, "vocab_size": 50, "spk_embed_dim": 12, "n_xvectors": 4, "encoder_dim": 32,
             "encoder_heads": 4, "encoder_ffn": 64, "encoder_layers": 2, "up_layers": 2, "chunk": 4,
             "estimator_channels": [32], "estimator_blocks": 1, "estimator_mid": 2, "estimator_heads": 2,
             "estimator_head_dim": 16, "compute_dtype": "float32"}
TINY_MIX = {"corpus": {"utterances": 24, "median_tokens": 14, "sigma": 0.4, "min_tokens": 5, "max_tokens": 30,
                       "vocab": 50, "speakers": 4}}
NEW_METRICS = ("mfu.cosytrain", "attn_share.cosytrain", "kernels_roofline.cosytrain", "device_idle_share.cosytrain",
               "peak_mem_gib.cosytrain", "pad_share.cosytrain", "batch_wait_ms.cosytrain")
SEED = 2**31 + 11


def tiny_run(seed: int = SEED, seconds: float = 2.0, trace: bool = False, fault=None, control=False):
    import torch

    from benchmark.run import execute

    torch.set_num_threads(1)
    over = {"config": {"model": TINY_COSY, "training": {"max_frames_per_batch": 300}}, "mix": TINY_MIX}
    return execute(CELL, seed, seconds, trace, device="cpu", overrides=over, fault=fault, control=control,
                   process_start=time.perf_counter())


def test_a_tiny_run_is_correct_and_judges_both_kinds_of_step():
    result, run, loaded = tiny_run()
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_frames_per_s", "setup_s"}
    assert result["attempted"] > 0 and not loaded
    kinds = {streaming for streaming, _, _ in run.extra["judged_draws"]}
    assert kinds == {True, False} and len(run.extra["judged_draws"]) >= 3
    assert set(run.extra["window_drawn"]) == {"streaming", "prompted", "dropped"}
    assert all("streaming" in s for s in run.steps)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_chunk"])
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
    assert {"mfu.cosytrain", "device_idle_share.cosytrain", "pad_share.cosytrain",
            "batch_wait_ms.cosytrain"} <= set(result["metrics"])
    assert set(result["metrics"]) <= set(NEW_METRICS)
    assert run.extra["launch_chunks"] == []  # the CPU runs the plain attention
    mask = torch.ones((2, 2048), dtype=torch.uint8)  # long rows: the products, not the bytes, bound them
    shape = (2, 8, 2048, 64)
    launches = [("fwd", shape, "bfloat16", True, mask), ("dkv", shape, "bfloat16", False, mask),
                ("dq", shape, "bfloat16", False, mask)]
    run.traced = {"busy_s": 1.0, "window_s": 2.0, "launches": launches,
                  "kernels": {"masked_attention_fwd_bf16": {"s": 0.1, "count": 1},
                              "attn_bwd_dkv_kernel": {"s": 0.15, "count": 1},
                              "attn_bwd_dq_kernel": {"s": 0.05, "count": 1}, "gemm": {"s": 0.7, "count": 9}}}
    run.extra["peak_mem_window_bytes"] = 3 * 2**30
    run.extra["launch_chunks"] = [("fwd", 0), ("dkv", 0), ("dq", 0)]
    read = {m: harness.reader(m)(run) for m in NEW_METRICS}
    assert all(v is not None and v >= 0 for v in read.values()), read
    assert read["attn_share.cosytrain"] == pytest.approx(30.0)
    assert read["peak_mem_gib.cosytrain"] == pytest.approx(3.0)
    # unchunked, the cell's roofline reads as the harness's own rule does
    assert read["kernels_roofline.cosytrain"] == pytest.approx(harness.reader("kernels_roofline.f5train")(run))
    full = read["kernels_roofline.cosytrain"]
    run.extra["launch_chunks"] = [("fwd", 64), ("dkv", 64), ("dq", 64)]
    chunked = harness.reader("kernels_roofline.cosytrain")(run)
    # the bound of a chunk-causal launch counts its kept pairs alone: about half of them
    assert 0.45 * full < chunked < 0.55 * full
    run.extra["launch_chunks"] = [("fwd", 0)]
    assert harness.reader("kernels_roofline.cosytrain")(run) is None  # records that do not align


def test_kept_keys_count_the_chunks_pairs():
    import torch

    from benchmark.flops_cosy import kept_pairs

    reader = harness.load_module(harness.BENCH / "metrics" / "kernels_roofline.cosytrain.py", "kr_cosy")
    masks = torch.zeros((2, 100), dtype=torch.uint8)
    masks[0, :100], masks[1, :40] = 1, 1
    want = (kept_pairs(100, 25) + sum(min(40, (i // 25 + 1) * 25) for i in range(100))) / 100
    assert reader.kept_keys(masks, 100, 25) == pytest.approx(want)
    assert reader.kept_keys(masks, 100, 0) == 140


def test_readers_find_nothing_without_a_slice():
    run = harness.Run(cell=CELL, seed=1, seconds=1.0, trace=False, cfg={}, mix={}, device=None)
    for m in ("attn_share.cosytrain", "mfu.cosytrain", "kernels_roofline.cosytrain"):
        assert harness.reader(m)(run) is None


def test_the_corpus_holds_tokens_at_half_the_frames(tmp_path, monkeypatch):
    driver = harness.driver("cosy_train_loop")
    monkeypatch.setattr(driver, "WORK", tmp_path)
    spec = {**TINY_MIX["corpus"], "token_mel_ratio": 2}
    root = driver.corpus_dir(spec, 7, 8)
    rows = (tmp_path / root / "train.csv").read_text().splitlines()
    assert len(rows) == 24
    for row in rows:
        rel, _, _, _, ids = row.split("|")
        ids = [int(i) for i in ids.split()]
        coarse = np.load(f"{root}/mels/{rel}.npy")
        fine = np.load(f"{root}/mels/{rel}.fine.npy")
        assert coarse.shape == (8, 2 * len(ids)) and fine.shape == (8, 4 * len(ids))
        assert 5 <= len(ids) <= 30 and max(ids) < 50


def test_the_judged_steps_hold_both_kinds():
    driver = harness.driver("cosy_train_loop")
    from benchmark.reference import cosyflow as ref

    for seed in (1, 2, 3, SEED, 2**31 + 5):
        n = driver.judged_steps(seed)
        kinds = [ref.draws(seed, s, 1)[0] for s in range(n)]
        assert n >= 3 and set(kinds) == {True, False} and (n == 3 or len(set(kinds[:-1])) == 1)
