"""Profile the training step on the card: wall time against device busy time.

The port's counterpart of ``tools/profile_step.py``.  It runs one
production ``TrainStep`` (``train/step.py``: forward, MAS, backward, clip,
AdamW) on a synthetic batch at one bucket and reports:

  * wall ms a step: median and spread (min, max, n) over ``--iters``
    steps, host clock around a step that ends in a synchronize, the first
    step (cuDNN plans, allocator pools) left out
  * real coarse frames a second: the batch's unpadded frames over that
    median (an epoch's card-hours are its frames over this rate)
  * peak memory: ``torch.cuda.max_memory_allocated`` after
    ``reset_peak_memory_stats``
  * device busy ms a step, device events and idle share, and the 5 kernels
    that take the most time, from a ``torch.profiler`` trace read by
    ``utils/trace_analysis.device_stats`` (idle share against the wall
    median, taken with the profiler off), and the step's split by its
    program spans (``trace_analysis.span_stats``: wall ms and device events
    of forward, MAS, backward, optimizer, ...)
  * ``mfu``: ``utils/flops.train_step_flops`` (forward and backward
    products) over the wall median over the H100's dense bf16 peak

The step is not captured as a CUDA graph: ``AdamW.update`` branches on the
host (``train/optim.py``), so device time comes from the trace alone.

The batch: ``--batch`` rows of ``--tx`` token and ``--frames`` coarse-frame
buckets, as the trainer's sampler fills them: each row's coarse length
drawn in the bucket's top sixteenth (the last row at the full bucket), its
tokens in proportion, random ids, mels and speakers from seed 0.  The
production points are B=62 × 512 (text bucket 224) and B=29 × 1088 (448)
at 32,000 frames a batch.

``--model f5`` profiles F5-TTS v1 Base's DiT step instead (``DiTConfig()``,
the published widths; ``models/dit.py``), by default at the f5-train
cell's longest bucket, B=13 × 2848 frames (text bucket 448), with
``utils/flops.dit_train_step_flops``; it also reports the steps whose
audio and text conditions were dropped (``F5TTS.dropped``).

Both models report ``dit_launches_per_step``: the launches a step of each
of the DiT's fused glue kernels (``ops/dit_fused.py``'s counters, forward
and backward), counted over the timed steps; 0 wherever the eager glue runs
(MatchaTTS, the CPU).

Usage:
    python -m matcha_tpu_torch.utils.profile_step [--batch 62] [--tx 224]
        [--frames 512] [--iters 5] [--compute_dtype bfloat16] [--remat]
    python -m matcha_tpu_torch.utils.profile_step --model f5 [--batch 13 --tx 448 --frames 2848]

Prints one JSON line.  ``--device cpu --tiny`` runs at tiny widths on the
CPU, for the tests: the device fields are then null.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

TOP_KERNELS = 5
TRACE_ITERS = 3  # steps in the traced loop


def synthetic_batch(cfg, b: int, tx: int, frames: int, seed: int = 0):
    """A padded ``Batch`` on the CPU: coarse lengths in the bucket's top
    sixteenth (the last row full), tokens in proportion to the frames."""
    from matcha_tpu_torch.train.step import Batch

    if tx > 2 * frames:
        raise ValueError(f"{tx} tokens cannot align to {2 * frames} fine frames")
    rng = np.random.default_rng(seed)
    y_len = rng.integers(frames - frames // 16, frames + 1, b)
    y_len[-1] = frames
    x_len = np.clip(y_len * tx // frames, 1, tx)
    x = rng.integers(1, 600, (b, tx)) * (np.arange(tx)[None] < x_len[:, None])
    y = rng.standard_normal((b, frames, cfg.n_feats)).astype(np.float32)
    y_fine = rng.standard_normal((b, 2 * frames, cfg.n_feats)).astype(np.float32)
    y *= (np.arange(frames)[None] < y_len[:, None])[..., None]
    y_fine *= (np.arange(2 * frames)[None] < 2 * y_len[:, None])[..., None]
    return Batch(*(torch.from_numpy(np.asarray(a)) for a in (
        x, x_len, y, y_len, y_fine, 2 * y_len, rng.integers(0, getattr(cfg, "n_spks", 1), b))))


def main(argv=None) -> int:
    from matcha_tpu_torch import bench
    from matcha_tpu_torch.inference import resolve_device
    from matcha_tpu_torch.models.config import DiTConfig, tiny_dit_config
    from matcha_tpu_torch.ops import dit_fused
    from matcha_tpu_torch.train.optim import OptimizerConfig
    from matcha_tpu_torch.train.step import TrainStep
    from matcha_tpu_torch.utils import profiling, trace_analysis
    from matcha_tpu_torch.utils.flops import dit_train_step_flops, train_step_flops

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=("matcha", "f5"), default="matcha")
    parser.add_argument("--batch", type=int, default=None, help="default 62 (matcha), 13 (f5)")
    parser.add_argument("--tx", type=int, default=None, help="default 224 (matcha), 448 (f5)")
    parser.add_argument("--frames", type=int, default=None,  # coarse mel frames
                        help="default 512 (matcha), 2848 (f5)")
    parser.add_argument("--iters", type=int, default=5, help="timed steps after the first")
    parser.add_argument("--compute_dtype", default="bfloat16")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize each decoder U-Net block in the backward pass (decoder.remat)")
    parser.add_argument("--device", default=None, help="torch device (default: the card)")
    parser.add_argument("--tiny", action="store_true", help="tiny widths, for the tests")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    on_card = device.type == "cuda"

    f5 = args.model == "f5"
    if f5 and args.remat:
        parser.error("--remat rematerialises MatchaTTS's decoder blocks; the DiT has none")
    if f5:
        cfg = dataclasses.replace(tiny_dit_config() if args.tiny else DiTConfig(), compute_dtype=args.compute_dtype)
        opt_cfg = OptimizerConfig(lr=7.5e-5, weight_decay=0.01, b2=0.999, grad_clip=1.0)
    else:
        cfg, _ = bench.configs(args.compute_dtype, args.tiny)
        opt_cfg = OptimizerConfig()
        if args.remat:
            cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, remat=True))
    b, tx, frames = (13, 448, 2848) if f5 else (62, 224, 512)
    b, tx, frames = args.batch or b, args.tx or tx, args.frames or frames
    batch = synthetic_batch(cfg, b, tx, frames).to(device)
    real_frames = int(batch.y_lengths.sum())
    ts = TrainStep(cfg, opt_cfg, device=device)
    state = ts.init_state(generator=torch.Generator().manual_seed(0))
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    for counter in dit_fused.COUNTERS:
        counter.reset()
    losses, times = [], []
    for i in range(args.iters + 1):  # the first step builds plans and pools
        bench._sync(device)
        t0 = time.perf_counter()
        state, m = ts.train_step(state, batch, 0)
        loss = float(m["loss"])  # the step's result on the host
        bench._sync(device)
        times.append(time.perf_counter() - t0)
        if not all(math.isfinite(float(v)) for v in m.values()):
            raise RuntimeError(f"non-finite metrics at step {i}: {m}")
        losses.append(loss)
    first, steady = times[0], times[1:]
    dit_launches = {c.name: c.launches / len(times) for c in dit_fused.COUNTERS}
    wall = statistics.median(steady)
    peak_gib = torch.cuda.max_memory_allocated(device) / 2**30 if on_card else None

    trace = mfu = None
    flops = dit_train_step_flops(cfg, b, frames) if f5 else train_step_flops(cfg, b, tx, frames)
    if on_card:
        with tempfile.TemporaryDirectory(prefix="profile_step_") as logdir:
            with profiling.trace(logdir):
                for _ in range(TRACE_ITERS):
                    state, m = ts.train_step(state, batch, 0)
            stats = trace_analysis.device_stats(logdir)
            spans = trace_analysis.span_stats(logdir)
        if not stats["device_events"]:
            raise RuntimeError(f"no device event in the trace (planes {stats['device_planes']})")
        n = TRACE_ITERS
        busy = stats["device_busy_ms"] / n
        trace = {"device_busy_ms_per_step": busy, "idle_share": 1.0 - busy / (wall * 1e3),
                 "device_events_per_step": stats["device_events"] / n,
                 "top_kernels": [[name[:90], m["ms"] / n, m["count"] / n]
                                 for name, m in list(stats["modules"].items())[:TOP_KERNELS]],
                 "spans": spans,
                 "method": "torch.profiler trace (utils/trace_analysis.device_stats); the step branches on "
                           "the host (train/optim.py), so it is not captured as a CUDA graph",
                 "trace_iters": n}
        mfu = flops / wall / bench.H100_PEAK_BF16_FLOPS

    out = {
        "wall_ms_per_step": bench._ms(wall),
        "spread_ms": bench.spread(steady),
        "first_step_ms": bench._ms(first),
        "real_coarse_frames": real_frames,
        "coarse_frames_per_s": real_frames / wall,
        "audio_seconds_per_batch": real_frames * 256 / 24000,
        "peak_memory_gib": peak_gib,
        "device_trace": trace,
        "mfu": mfu,
        "flops_per_step": flops,
        "mfu_flops_source": "analytic",
        "losses": {"first": losses[0], "last": losses[-1]},
        "dit_launches_per_step": dit_launches,
        "batch": b, "tx": tx, "coarse_frames": frames, "compute_dtype": cfg.compute_dtype,
        "remat": args.remat, "model": args.model, "device": bench.device_info(device),
    }
    if f5:
        out["dropped"] = dict(ts.model.dropped)
    if not on_card:
        out["not_measured"] = ["peak_memory_gib", "device_trace", "mfu"]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
