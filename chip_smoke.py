"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one CUDA card (an H100: the kernels build for sm_90a) and the
``matcha_tpu_torch`` package beside this file.  Exits non-zero, printing no
result, without a card or without the package.  Phases, each printing one
JSON line:

  1. device   card name, count, ``nvidia-smi`` name and power limit
  2. build    compile every hand-written kernel from ops/csrc
  3. kernels  each kernel against its plain PyTorch version on the card
              (masked attention forward: max abs error, bf16 through the
              wrapper and each of its two layouts, at the B=1, B=16 and
              ragged shapes and a padded head dim; its log2 log-sum-exp
              against the plain one, with a batch row that has no valid
              key (+inf lse, NaN output); its
              backward: max |err| / max |ref| of dq, dk, dv against
              autograd through the plain version, and each backward kernel
              alone against the plain version of its own contract, from the
              log-sum-exp the forward kernel wrote; MAS: indices equal to
              the plain version and to the numpy oracle), then timed with
              CUDA events beside the plain version, the bound and the
              library call, K1 at the B=1, B=16 and training shapes, MAS on
              each side of its Tx dispatch boundary; every bf16 attention
              kernel's and the MAS kernels' registers, shared memory and
              spills
  4. model    synthesis at full width (MatchaConfig + VocosConfig, bf16,
              random weights from a seeded torch.Generator) through the
              synthesizer's entry points: fused B=1 at the production
              bucket (text 256 → fine mel 1024), synthesise_batch at B=16,
              one long request at decoder T=2048
  5. server   the port's HTTP server in-process: /health and three speech
              requests (two concurrent) answered as WAV
  6. profile  one B=1 and one B=16 fused request under torch.profiler
  7. reference  synthesis at full width in fp32, the kernel path against
              the plain path on a small input
  8. train    the training path: a Trainer at full width, bf16, over a
              synthetic corpus (buckets 512 at B=62 and 1088 at B=29, each
              run at least twice): per-step losses, grad norm, step time,
              launches per step; its checkpoint served by load_synthesizer
  9. train_learns  20 steps on one fixed B=4 batch must cut the loss 10 %,
              and each sub-loss (diff, dur, prior) must fall
 10. train_reference  fp32, full width: losses and every gradient of the
              kernel path against the plain path
 11. train_profile  one B=62 training step under torch.profiler
 12. mel_frontend  coarse and fine log-mel of the ten ``mcd_validation/``
              recordings on the card against a float64 numpy reference,
              and ``precompute_mels.extract_pair``'s audio seconds per wall
              second
 13. corpus_prep  those recordings through ``generate_data_statistics`` and
              ``precompute_mels`` on the card, the cache read back by
              ``TextMelDataset`` and trained one ``Trainer`` step
 14. finetune_speaker  3 steps of ``finetune_speaker.finetune`` (B=62 x
              512) from a full-width random checkpoint: frozen parameters
              and other speakers' rows bitwise unchanged; one step profiled
 15. style_encoder  20 ``train_style_encoder.train`` steps on one B=62
              batch against the frozen checkpoint; fp32 kernel path against
              plain path (loss, StyleEncoder gradients); one step profiled
 16. add_speaker  a Vocos pickle, ``add_speaker`` on the ten recordings
              (16 → 17 speakers), the new speaker served at B=1 fused
 17. cli_mcd  the synthesis CLI for speakers 0 and 16, ``compute_mcd``,
              ``vocoder.selftest`` and ``mcd_validate``: finite MCDs (random
              weights: a check of the tools, not of quality)
 18. checkpoint_crossing  a Trainer's checkpoint after one step holds the
              JAX trainer's key paths (the list the CPU tests pin); reloaded,
              it takes the next step as the uninterrupted state does
 19. dp_train  data-parallel Trainers over the 62 utterances of bucket 512:
              world 1 over NCCL against one process (3 steps), and at
              dropout 0 two spawned ranks over gloo on this card (31 + 31
              rows) against world 1; step times, peak memory and launches
              per rank
 20. seeded_noise  two equal B=1 fused requests give equal audio; bucket
              noise is a prefix of the largest bucket's row; the seed-42 row
              against the JAX package's values
 21. fanout   the synthesizer fanned out over two replicas on this card
              against the single one: B=16 fused, a padded 3-request batch,
              one request; wall times
 22. tp_train  tensor parallelism at configs/experiment/v20-production.yaml's
              widths (decoder 384 = 6 x 64, encoder 6 x 48), dropout 0: one
              process, then two spawned ranks dp 1 x tp 2 over gloo on this
              card, B=62 x 512: in bf16 3 steps (losses and gathered
              parameters against one process and beside its spread against
              itself; step time, peak memory and launches per rank, K1 at 3
              heads), in fp32 one step; the tp=2 checkpoint reloaded at tp=1
 23. conformer  block_type="conformer" at MatchaConfig() widths: B=1 fused
              p50 and B=16 RTF (K1 exactly 100 times a request), 3 training
              steps at B=62 x 512 with dropout on
 24. remat    the production training step with and without remat: loss
              equal, gradients within the step's own run-to-run noise, peak
              memory and step time of each, K1 twice per decoder block
 25. norm_stats  B=1 synthesis with bf16 and fp32 norm statistics: mel max
              |Δ| and fused p50 of each
 26. durations  the segment DP (maximum_path_durations) against K2+K3's
              durations at (62, 224, 1024); torch.cummax's tie rule; times
 27. measure  after phase 6: utils/probe.inner_repeat (a CUDA-graph replay)
              on the decode stage at B=1 and B=16 beside utils/
              trace_analysis.device_stats of a traced decode; device_stats
              of a profiled B=1 fused request beside device_breakdown's
              busy time (which phases 6, 11, 14 and 15 now read through
              trace_analysis too); wait_for_backend on a live card
 28. native_train  after phase 11: a Trainer on the card (the native C++
              batch loader, built from native/src with g++) over phase 8's
              corpus, 3 steps; one batch equal to collate_numpy's; collate
              and step times (host); the Ogg/Opus encoder from that library
 29. reference_ckpt  after phase 24: a Lightning .ckpt and an HF Vocos
              pytorch_model.bin at v20 widths through the port's converter
              CLIs, load_synthesizer, one B=1 fused request bit-equal to a
              direct build, one WAV and one Ogg/Opus server request; K1
              exactly 100 times each
 30. hw_parity  after phase 21: utils/hw_parity.py's production operating
              point (MatchaConfig() + VocosConfig(), speaker 2, 40 ids; a
              4 x 32 x 64 training step in bf16 and in fp32) against the JAX
              package's CPU fp32 oracle in tests/data/torch_e2e_oracle.npz,
              with the JAX tier's bars (tests/test_tpu_e2e.py): fp32 mel
              MCD < 0.1 dB, bf16 < 0.3 dB, durations <= 1 frame on <= 15 %
              of tokens, fused against two-stage < 0.15 dB, train losses
              rtol 0.05, update_l1 0.10; launches of each run held to their
              exact counts
 31. bench    after phase 27: ``python -m matcha_tpu_torch.bench`` in-process
              at 5 timed B=16 calls and 20 B=1 calls: the parity line with no
              bar missed, then the headline (fused B=16 RTF at text 256 →
              fine 1024, midpoint/4, durations pinned) with bench.py's keys,
              an MFU in (0, 1) from the analytic FLOP count, spreads, the
              probe, the idle shares and the audio's device→host copy
 32. profile_stage_b  ``utils/profile_stage_b`` at B=16, every component
              a CUDA-graph replay; stage_b against ode + vocos + align
 33. profile_step  ``utils/profile_step`` at B=62 x 512: step time, real
              frames a second, peak memory, busy time and idle share, MFU
              Phases 31-33 run outside every counted window (a probe counts
              its kernels once, at capture).
 34. ab_fast_solvers  after phase 30: ``utils/ab_fast_solvers`` in-process at
              B=16, text 256, fine 1024, bf16: midpoint/4, euler/4,
              midpoint/2, euler/8 each a CUDA-graph replay, with its mel MCD
              against midpoint/4 (itself at 0); euler/4 and midpoint/2 under
              0.65 x midpoint/4's device time; K1 counted exactly (the probe
              counts a chain's launches once, at capture)
 35. ab_stage_b_levers  ``utils/ab_stage_b_levers`` in-process: bf16 norm
              statistics and the fp32 carry (device ms, mel MCD > 0), the
              decoder's convs in both layouts beside their bounds, the two
              layouts' outputs equal in bf16 and fp32; K1 counted exactly
 36. live_serving  first its path in-process and counted (phase
              live_serving_path): the legs' checkpoint loaded as the server
              loads it, TTSService with the ladder 1..16 warmed, fused 0 and
              1, each under ``psr/load_test.py --ids`` (20 users, 6 s) over
              HTTP; K1 counted exactly, its signatures held by phase
              path_signatures.  Then ``utils/live_serving_ab``: the port's
              server booted per leg (max batch 8 and 16, fused 0 and 1)
              under the load test at 20 users for 10 s; every leg answers
              with no error
 37. progressive_boot  ``utils/measure_progressive_boot``: time to healthy
              with WARMUP_PROGRESSIVE=1 against a full warmup; /health
              answers 200 while still "warming", and a WAV is served then
              The servers of phases 36-37 run K1 in their own processes,
              outside every counted window.
 38. bucket_invariance  after phase 30: tests/test_torch_fused_parting.py's
              walk at the parity point in bf16 (with the fp32 and with the
              bf16 norm statistics): the decode's U-Net evaluations at
              decoder T=128 and T=256 under forward hooks, the first module
              whose valid frames differ (or null), and the request's fused against
              two-stage mel MCD and wav max |Δ|, held under the tier's bar
              (0.15 dB); the card's nvidia-smi name and power limit
 (3b.) kernel_time at the new signatures: K1 with and without lse and K1b
              at the encoder's training shape (62,6,224,48), v20's
              (62,6,512,64) and the tp=2 halves (62,3,512,64), (62,3,224,48),
              each checked against its plain version, beside SDPA; then
              the same at F5-TTS's DiT shapes (DIT_SIGNATURE_SHAPES); then
              chunked_attention: K1 (with and without lse) and K1b
              chunk-causal at CosyVoice 2's estimator shapes
              (COSY_SIGNATURE_SHAPES, chunk 50), bf16 and fp32, against
              the plain versions, and each timed at chunk 50 and chunk 0
              beside its bound over the kept (query, key) pairs
 39. adamw    after phase 3: the multi-tensor AdamW (ops/adamw.py) against
              the plain loop at MatchaConfig()'s 387 parameters, 4 updates
              (clipped, not clipped, a NaN skipped, again) for the recipe,
              the fine-tune's trainable mask, an external norm and two
              accumulated gradients: p's change, mu, nu and the norm, the
              four device scalars equal, no sync under
              set_sync_debug_mode("error"), one launch of each wrapper an
              update; CPU, strided and bf16 gradients refused; the update's
              device time beside its bound, the loop and torch._fused_adamw_.
              Phase 8 holds one launch of each wrapper to every step
 40. dit_fused  after phase 39: F5-TTS's fused DiT glue (ops/dit_fused.py):
              modulate, rope_heads, gated_residual (attention branch with
              dropout and ragged rows, FFN branch) and gelu_dropout, each
              forward and backward against its plain version at the
              f5-train mix's 13 x 2848, 52 x 736 and 240 x 160 (the dropout
              bits exactly), a synchronize after the launches, each call's
              device time beside its byte bound and its plain version's;
              then one bf16 DiT step at 13 x 2848 against the plain fp32
              reference (tests/plain_f5tts.py) on the same draws and masks:
              loss and every leaf's gradient norm within f5-train's judge
              limits, the launches of each kernel a step held to their
              exact counts

The launch counters are set to 0 just before each main path (phases 4-5,
synthesis; phase 8, training; each of phases 13-17, 19, 21, 22-25, 28,
29, 30, 34, 35, 36's in-process path and 38) and
read just after: the kernels line reports those launches, by path.  The last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import glob
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import wave

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-3  # log2 units: fp32 sums in another order, exp2 against exp


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 21, per_rep: int = 10, warmup: int = 3) -> float:
    """Device time of one ``fn`` call: CUDA events around ``per_rep``
    back-to-back calls, divided by ``per_rep``; the median of ``reps``.

    A spin kernel of about 2.5 ms runs before the start event, so the host
    has queued every call before the device reaches them: the events time
    the device's work, not the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def attention_bound_ms(b, h, t, d, dtype, n_valid_keys, with_lse=False) -> tuple[float, str]:
    """Least time for one call: q, k, v read once, out (and the fp32 lse)
    written once, the (B, T) mask read once; 4·B·H·T·(valid keys)·D flops
    at the dtype's peak."""
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * h * t * d * elem + b * t + (4 * b * h * t if with_lse else 0)
    flops = 4 * b * h * t * d * n_valid_keys
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
           "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    emit({"phase": "device", **dev})
    return dev


def phase_build() -> None:
    """The CUDA kernels (one extension) and the native batch loader's
    library (g++ from native/src), both from the checkout's sources."""
    from matcha_tpu_torch.data import native_loader
    from matcha_tpu_torch.ops.extension import kernels

    t0 = time.perf_counter()
    kernels()
    t1 = time.perf_counter()
    native_loader.load_library()
    emit({"phase": "build", "seconds": round(t1 - t0, 3), "native_loader_seconds": round(time.perf_counter() - t1, 3),
          "native_loader": os.path.relpath(native_loader.library_path(), ROOT)})


K1_CHECK_SHAPES = [(16, 6, 256, 48), (16, 5, 512, 64), (16, 5, 256, 64), (2, 6, 4000, 48), (3, 5, 333, 64),
                   (1, 6, 256, 48), (1, 5, 512, 64), (1, 5, 256, 64), (2, 3, 96, 36)]
K1_LSE_SHAPES = [(62, 5, 512, 64), (3, 5, 333, 64), (2, 6, 4000, 48)]
# (shape, with_lse): the B=1 request, the B=16 batch, the training step
K1_TIME_SHAPES = [((1, 6, 256, 48), False), ((1, 5, 512, 64), False), ((1, 5, 256, 64), False),
                  ((16, 6, 256, 48), False), ((16, 5, 512, 64), False), ((16, 5, 256, 64), False),
                  ((62, 5, 512, 64), True), ((29, 5, 1088, 64), True)]
# device times of the mma.sync K1 this design replaced, on an NVIDIA H100
# 80GB HBM3 at 700 W (kernel_timing.py on the parent checkout; PERF.md)
K1_EARLIER_MS = {(1, 6, 256, 48): 0.01087, (1, 5, 512, 64): 0.01827, (1, 5, 256, 64): 0.01116,
                 (16, 6, 256, 48): 0.01596, (16, 5, 512, 64): 0.04801, (16, 5, 256, 64): 0.01782,
                 (62, 5, 512, 64): 0.1744, (29, 5, 1088, 64): 0.3268}


def ragged_valid(b, t, gen, empty_row=False):
    """(B, T) float mask: random key lengths, row 0 one key, the last row
    all T; with ``empty_row``, row 1 has no valid key."""
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    lengths[0], lengths[-1] = 1, t
    if empty_row:
        lengths[1] = 0
    return (torch.arange(t, device="cuda")[None] < lengths[:, None]).float(), lengths


def check_k1(shape, dtype, gen, at="list", chunk=0) -> float:
    """K1 without lse at ``shape`` (ragged key lengths; ``chunk`` > 0
    chunk-causal) through the wrapper and, in bf16, each layout alone,
    against the plain version: max |err|."""
    from matcha_tpu_torch.ops import attention as att

    valid, lengths = ragged_valid(shape[0], shape[2], gen)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    ref = att.masked_self_attention_plain(q.float(), k.float(), v.float(), valid, chunk=chunk)
    runs = {"wrapper": lambda: att.masked_attention_fwd(q, k, v, valid, chunk=chunk)}
    if dtype == torch.bfloat16:
        u8 = valid.to(torch.uint8)
        runs.update({f"layout_{n}": (lambda n=n: att._launch_fwd(q, k, v, u8, False, layout=n, chunk=chunk)[0])
                     for n in (1, 2)})
    errs = {}
    for name, run in runs.items():
        out = run()
        torch.cuda.synchronize()
        check(out.shape == q.shape and out.dtype == dtype, f"K1 output {out.shape} {out.dtype}")
        errs[name] = (out.float() - ref).abs().max().item() if torch.isfinite(out).all() else math.inf
    err = max(errs.values())
    ok = err <= TOL[dtype]
    emit({"phase": "kernel_check", "kernel": "masked_attention_fwd", "shape": list(shape),
          "dtype": str(dtype).split(".")[-1], "chunk": chunk, "shapes_from": at, "key_lengths": lengths.tolist()[:8],
          "max_abs_err": errs, "tol": TOL[dtype], "ok": ok})
    check(ok, f"masked_attention_fwd disagrees with its plain version at {shape} {dtype} chunk {chunk}: {errs}")
    return err


def check_k1_lse(shape, dtype, gen, at="list", chunk=0) -> tuple[float, float]:
    """K1 with lse at ``shape`` (``chunk`` > 0 chunk-causal), each bf16
    layout alone, against the plain output and lse; with B > 1 one batch row
    has no valid key (+inf lse, NaN output).  Returns (max |err| of the
    output, of the lse)."""
    from matcha_tpu_torch.ops import attention as att

    valid, lengths = ragged_valid(shape[0], shape[2], gen, empty_row=shape[0] > 1)
    u8 = valid.to(torch.uint8)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    ref = att.masked_self_attention_plain(q.float(), k.float(), v.float(), valid, chunk=chunk)
    ref_lse = att.masked_attention_lse_plain(q, k, valid, chunk=chunk)
    finite, keep = torch.isfinite(ref_lse), ~torch.isnan(ref)
    worst, worst_lse = 0.0, 0.0
    for layout in ((1, 2) if dtype == torch.bfloat16 else (0,)):
        out, lse = att._launch_fwd(q, k, v, u8, True, layout=layout, chunk=chunk)
        torch.cuda.synchronize()
        inf_same = bool(torch.equal(torch.isinf(lse), ~finite) and (lse[~finite] > 0).all())
        nan_same = bool(torch.equal(torch.isnan(out), ~keep))
        lse_err = (lse[finite] - ref_lse[finite]).abs().max().item()
        err = (out.float()[keep] - ref[keep]).abs().max().item()
        ok = inf_same and nan_same and lse_err <= LSE_TOL and err <= TOL[dtype]
        emit({"phase": "kernel_check", "kernel": "masked_attention_fwd_lse", "shape": list(shape),
              "dtype": str(dtype).split(".")[-1], "layout": layout, "chunk": chunk, "shapes_from": at,
              "key_lengths": lengths.tolist()[:4], "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
              "empty_row_lse_inf": inf_same, "empty_row_out_nan": nan_same,
              "max_abs_err": err, "tol": TOL[dtype], "ok": ok})
        check(ok, f"K1's lse or output disagrees at {shape} {dtype} layout {layout} chunk {chunk}: lse {lse_err}, "
                  f"out {err}, +inf rows {inf_same}, NaN rows {nan_same}")
        worst, worst_lse = max(worst, err), max(worst_lse, lse_err)
    return worst, worst_lse


def phase_kernels() -> dict:
    """K1 against its plain version at the paths' shapes (bf16 through the
    wrapper and each layout on its own), its lse against the plain lse with a
    batch row that has no valid key, then timed."""
    import torch.nn.functional as F

    from matcha_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for shape in K1_CHECK_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            worst = max(worst, check_k1(shape, dtype, gen))

    worst_lse = 0.0
    for shape in K1_LSE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            err, lse_err = check_k1_lse(shape, dtype, gen)
            worst, worst_lse = max(worst, err), max(worst_lse, lse_err)

    timed = {}
    for shape, with_lse in K1_TIME_SHAPES:
        b, h, t, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3))
        valid = torch.ones((b, t), device="cuda")
        u8 = valid.to(torch.uint8)
        keep = valid[:, None, None, :] > 0
        ms = cuda_ms(lambda: att._launch_fwd(q, k, v, u8, with_lse))
        layouts = {n: cuda_ms(lambda n=n: att._launch_fwd(q, k, v, u8, with_lse, layout=n)) for n in (1, 2)}
        plain_ms = cuda_ms(lambda: att.masked_self_attention_plain(q, k, v, valid))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep))
        bound_ms, bound_by = attention_bound_ms(b, h, t, d, torch.bfloat16, t, with_lse)
        timed[shape] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by, tflops=4 * b * h * t * t * d / (ms * 1e-3) / 1e12,
                            earlier_ms=K1_EARLIER_MS.get(shape),
                            layout=kernels_ext().masked_attention_fwd_layout(b, h, t),
                            layout_ms={str(n): x for n, x in layouts.items()})
        emit({"phase": "kernel_time", "kernel": "masked_attention_fwd", "shape": list(shape),
              "dtype": "bfloat16", "with_lse": with_lse,
              "earlier": "earlier_ms: the mma.sync kernel this design replaced (PERF.md)", **timed[shape]})
    return {"max_abs_err": worst, "lse_max_abs_err": worst_lse, "timed": timed}


def kernels_ext():
    from matcha_tpu_torch.ops.extension import kernels

    return kernels()


def production_synthesizer(compute_dtype: str, attention_backend: str = "auto", seed: int = 0,
                           decoder: dict | None = None, **kwargs):
    """Full-width MatchaConfig + VocosConfig with random weights from a seeded
    generator (``decoder``: DecoderConfig fields to change).  The duration
    head is set to a constant 4 fine frames per token (log(2 + 4)): random
    log-durations collapse to the 1-frame floor, which would make every
    request far shorter than speech."""
    import dataclasses

    from matcha_tpu_torch.inference import MatchaSynthesizer
    from matcha_tpu_torch.models.config import MatchaConfig
    from matcha_tpu_torch.models.matcha import init_params
    from matcha_tpu_torch.vocoder.vocos import VocosConfig, init_vocos_params

    cfg = dataclasses.replace(MatchaConfig(), compute_dtype=compute_dtype,
                              attention_backend=attention_backend)
    if decoder:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **decoder))
    vcfg = VocosConfig(compute_dtype=compute_dtype)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen)
    params["encoder.proj_w.proj.weight"].zero_()
    params["encoder.proj_w.proj.bias"].fill_(math.log(6.0))
    return MatchaSynthesizer(cfg, params, init_vocos_params(vcfg, gen), vcfg, **kwargs)


def ids_of(n: int, seed: int) -> list[int]:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(1, 600, (n,), generator=gen).tolist()


def expected_samples(n_tokens: int) -> int:
    """4 fine frames per token → coarse frames → samples (hop 256)."""
    return ((4 * n_tokens + 1) // 2 - 1) * 256


def check_wav(wav, n_tokens: int, what: str) -> None:
    import numpy as np

    check(np.isfinite(wav).all(), f"{what}: non-finite samples")
    check(len(wav) > 0 and np.abs(wav).max() > 1e-3, f"{what}: silent")
    check(len(wav) <= expected_samples(n_tokens), f"{what}: {len(wav)} samples > {expected_samples(n_tokens)}")


def phase_model(synth, count) -> dict:
    """The main path through the synthesizer's entry points (bf16)."""
    # production point: text bucket 256 → fused fine-mel bucket 1024
    ids = ids_of(200, 1)
    check(synth.predict_fine_bucket(256, 1.0) == 1024, "production bucket is not 1024")
    synth.synthesise_ids(ids, scale_correction=1.0, fused=True)  # first call: allocator, cuDNN
    torch.cuda.synchronize()
    lat, per_request = [], []
    for _ in range(10):
        before = count.launches
        r = synth.synthesise_ids(ids, scale_correction=1.0, fused=True)
        per_request.append(count.launches - before)
        lat.append(r.latency_s)
        check_wav(r.wav, len(ids), "B=1 fused")
    # trailing-silence trimming may take at most a few 10 ms windows
    check(len(r.wav) >= expected_samples(len(ids)) - 2400, f"B=1 fused: {len(r.wav)} samples")
    # every attention call launches the kernel once
    expected = request_launches(synth.cfg)
    check(all(n == expected for n in per_request),
          f"fused requests launched the kernel {per_request} times, expected {expected} each")

    # throughput point: B=16 through the batcher's entry point, fused
    lists = [ids_of(180 + 4 * i, 100 + i) for i in range(16)]
    mixes = [[(15, 1.0)]] * 16  # voice 15 carries no scale correction → bucket 1024
    synth.synthesise_batch(lists, voice_mixes=mixes, fused=True)
    rtfs = []
    for _ in range(3):
        res = synth.synthesise_batch(lists, voice_mixes=mixes, fused=True)
        for ids_k, r in zip(lists, res):
            check_wav(r.wav, len(ids_k), "B=16 fused")
        rtfs.append(res[0].rtf)
        b16_latency = res[0].latency_s

    # one long request: text bucket 1024 → fused fine bucket 4096 → decoder T=2048
    long_ids = ids_of(800, 7)
    check(synth.predict_fine_bucket(1024, 1.0) == 4096, "long bucket is not 4096")
    before = count.launches
    r = synth.synthesise_ids(long_ids, scale_correction=1.0, fused=True)
    check_wav(r.wav, len(long_ids), "long request")
    out = {"phase": "model", "compute_dtype": synth.cfg.compute_dtype,
           "weights": "random (seeded torch.Generator)",
           "b1_fused_latency_ms_p50": statistics.median(lat) * 1e3,
           "b1_fused_latency_ms": [x * 1e3 for x in lat],
           "b1_audio_s": len(ids) * 4 * 128 / 24000,
           "b16_fused_rtf_median": statistics.median(rtfs), "b16_fused_rtf": rtfs,
           "b16_latency_ms": b16_latency * 1e3,
           "kernel_launches_per_fused_request": per_request[0],
           "long_request": {"tokens": len(long_ids), "decoder_T": 2048, "samples": len(r.wav),
                            "latency_ms": r.latency_s * 1e3, "launches": count.launches - before}}
    emit(out)
    return out


def phase_server(synth) -> dict:
    """The port's TTSService + handler on a free port; stdlib client."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    from http.server import ThreadingHTTPServer

    from unittest import mock

    from matcha_tpu_torch.serving.server import TTSService, make_handler

    with mock.patch.dict(os.environ, BATCHER_MAX_WAIT_MS="200"):  # let the two concurrent requests meet
        service = TTSService(synth, use_batcher=True)
    group_sizes = []
    real_batch = synth.synthesise_batch

    def counting_batch(id_lists, **kw):
        group_sizes.append(len(id_lists))
        return real_batch(id_lists, **kw)

    synth.synthesise_batch = counting_batch
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        service.warmup()
        with urllib.request.urlopen(url + "/health", timeout=60) as resp:
            health = json.loads(resp.read())
        check(health.get("status") == "ok", f"/health: {health}")

        def speak(ids):
            body = json.dumps({"phoneme_ids": ids, "voice": "15", "response_format": "wav"}).encode()
            req = urllib.request.Request(url + "/v1/audio/speech", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status, resp.read()

        requests = [ids_of(150, 201), ids_of(170, 202), ids_of(190, 203)]
        results = [speak(requests[0])]
        with ThreadPoolExecutor(2) as pool:
            results += list(pool.map(speak, requests[1:]))
        samples = []
        for ids, (status, data) in zip(requests, results):
            check(status == 200 and data[:4] == b"RIFF" and data[8:12] == b"WAVE", "not a WAV response")
            with wave.open(io.BytesIO(data)) as f:
                check(f.getframerate() == 24000 and f.getnchannels() == 1, "WAV format")
                n = f.getnframes()
            check(0 < n <= expected_samples(len(ids)), f"WAV length {n}")
            samples.append(n)
        check(max(group_sizes) >= 2, f"concurrent requests were not grouped: {group_sizes}")
    finally:
        synth.synthesise_batch = real_batch
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        if service.batcher is not None:
            service.batcher.shutdown()
    out = {"phase": "server", "health": health, "wav_samples": samples, "group_sizes": group_sizes}
    emit(out)
    return out


def device_breakdown(run, kernels=("masked_attention_fwd",)) -> dict:
    """One ``run()`` under the port's profiler (``utils/profiling.trace``),
    read by ``utils/trace_analysis.device_stats``: the device's busy time
    (union of kernel, memcpy and memset intervals), the attention kernel's
    share of it, each named kernel's time, launches and share, and the
    kernels that take the most time.  Host wall time is taken with the
    profiler off, around the same call ending in a synchronize."""
    from matcha_tpu_torch.utils import profiling, trace_analysis

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as logdir:
        with profiling.trace(logdir):
            run()
        stats = trace_analysis.device_stats(logdir)
    modules = stats["modules"]
    busy_ms = stats["device_busy_ms"]

    def named(pattern) -> dict:
        ms = sum(m["ms"] for n, m in modules.items() if pattern in n)
        return {"ms": ms, "launches": sum(m["count"] for n, m in modules.items() if pattern in n),
                "share_of_busy": ms / busy_ms if busy_ms else None}

    attention = named("masked_attention_fwd")
    return {"wall_ms": wall_ms, "device_events": stats["device_events"], "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if stats["device_events"] else None,
            "attention_ms": attention["ms"], "attention_launches": attention["launches"],
            "attention_share_of_busy": attention["share_of_busy"],
            "kernels": {pattern: named(pattern) for pattern in kernels},
            "top_kernels_ms": [[n[:90], m["ms"]] for n, m in list(modules.items())[:8]],
            "trace": {"wall_span_ms": stats["wall_span_ms"], "device_planes": stats["device_planes"]}}


def phase_profile(synth) -> dict:
    """Where the time of the main path goes on the device, B=1 and B=16.
    The audio's device-to-host copy is named apart (``Memcpy DtoH``): its
    time depends on the host's pages as much as on the card."""
    ids = ids_of(200, 1)
    lists = [ids_of(180 + 4 * i, 100 + i) for i in range(16)]
    mixes = [[(15, 1.0)]] * 16
    named = ("masked_attention_fwd", "Memcpy DtoH")
    out = {"phase": "profile",
           "b1_fused": device_breakdown(lambda: synth.synthesise_ids(ids, scale_correction=1.0, fused=True), named),
           "b16_fused": device_breakdown(lambda: synth.synthesise_batch(lists, voice_mixes=mixes, fused=True),
                                         named)}
    emit(out)
    return out


def phase_reference() -> dict:
    """fp32 at full width: the path through the kernels against the path
    through the plain versions, same weights, small input."""
    ids = ids_of(40, 11)
    runs = {}
    for backend in ("auto", "einsum"):
        synth = production_synthesizer("float32", backend, seed=3)
        r = synth.synthesise_ids(ids, scale_correction=1.0, debug=True)
        runs[backend] = r
        del synth
    kern, plain = runs["auto"], runs["einsum"]
    check(kern.mel.shape == plain.mel.shape, "mel shapes differ")
    mel_err = float(abs(kern.mel - plain.mel).max())
    wav_err = float(abs(kern.wav - plain.wav).max())
    tol = 1e-2  # denormalized log-mel; fp32 through 8 U-Net evaluations
    out = {"phase": "reference", "compute_dtype": "float32", "mel_shape": list(kern.mel.shape),
           "mel_max_abs_err": mel_err, "wav_max_abs_err": wav_err, "tol": tol}
    emit(out)
    check(mel_err <= tol, f"kernel path and plain path disagree: {mel_err}")
    return out


# ---------------------------------------------------------------------------
# the training slice: MAS (K2+K3) and the attention backward (K1b)
# ---------------------------------------------------------------------------

TRAIN_SHAPES = [(62, 5, 512, 64), (62, 5, 256, 64), (29, 5, 1088, 64), (29, 5, 544, 64)]
# the two training buckets, a ragged small case, and Tx = 512 / 513: the
# last shape of the one-warp DP kernel and the first of the block-wide one
MAS_SHAPES = [(62, 224, 1024), (29, 448, 2176), (3, 37, 333), (3, 512, 700), (3, 513, 700)]
# device times of the block-barrier MAS kernel this design replaced, on an
# NVIDIA H100 80GB HBM3 at 700 W (kernel_timing.py on the parent checkout)
MAS_EARLIER_MS = {(62, 224, 1024): 0.5863, (29, 448, 2176): 1.6761}


def mas_bound_ms(b, tx, ty) -> tuple[float, str]:
    """value read once, indices written once (the DP's adds and maxes are
    noise beside the bytes at the fp32 peak)."""
    nbytes = b * tx * ty * 4 + b * ty * 4 + 2 * b * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 2 * b * tx * ty / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def attention_bwd_bound_ms(b, h, t, d, dtype, n_valid_keys, products, tensors) -> tuple[float, str]:
    """``products`` matrix products of 2·B·H·T·(valid keys)·D flops each;
    ``tensors`` (B, H, T, D) tensors read or written once, plus the fp32
    lse and delta rows and the mask."""
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = tensors * b * h * t * d * elem + 2 * b * h * t * 4 + b * t
    flops = 2 * products * b * h * t * d * n_valid_keys
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def mas_inputs(shape, gen, kind="ragged"):
    b, tx, ty = shape
    value = torch.randn(shape, generator=gen, device="cuda") * 3.0
    x_len = torch.randint(1, tx + 1, (b,), generator=gen, device="cuda")
    y_len = torch.randint(1, ty + 1, (b,), generator=gen, device="cuda")
    x_len[0] = 1                       # a one-token row
    x_len[-1], y_len[-1] = tx, ty      # a full row
    if b > 2:
        y_len[1] = x_len[1]            # pure diagonal
    if kind == "ties":
        value = torch.full(shape, -1.0, device="cuda")
    return value, x_len, y_len


def check_mas(shape, gen, kind, at="list") -> None:
    """MAS at ``shape`` on ragged (or all-tied) values: indices equal to the
    plain version's."""
    from matcha_tpu_torch.ops import mas

    value, x_len, y_len = mas_inputs(shape, gen, kind)
    got = mas.maximum_path_indices_kernel(value, x_len, y_len)
    torch.cuda.synchronize()
    ref = mas.maximum_path_indices_plain(value, x_len, y_len)
    equal = bool(torch.equal(got, ref))
    emit({"phase": "kernel_check", "kernel": "mas", "shape": list(shape), "values": kind, "shapes_from": at,
          "x_len": x_len.tolist()[:4], "y_len": y_len.tolist()[:4],
          "indices_equal": equal, "mismatches": int((got != ref).sum())})
    check(equal, f"mas indices differ from the plain version at {shape} ({kind})")


def phase_training_kernels() -> dict:
    """MAS and K1b against their plain versions on the card, then timed."""
    import numpy as np
    import torch.nn.functional as F

    from matcha_tpu_torch.ops import attention as att
    from matcha_tpu_torch.ops import mas

    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in MAS_SHAPES:
        for kind in ("ragged", "ties"):
            check_mas(shape, gen, kind)
    # the textbook oracle on two feasible rows (x_len <= y_len)
    value, x_len, y_len = mas_inputs((3, 37, 333), gen)
    x_len[:] = torch.tensor([37, 20, 9], device="cuda")
    y_len[:] = torch.tensor([333, 150, 9], device="cuda")
    got = mas.maximum_path_indices_kernel(value, x_len, y_len).cpu().numpy()
    v_np = value.cpu().numpy()
    for row in (0, 1):
        xl, yl = int(x_len[row]), int(y_len[row])
        oracle = mas.maximum_path_numpy(v_np[row], xl, yl)[:, :yl].argmax(axis=0)
        ok = bool(np.array_equal(got[row, :yl], oracle))
        emit({"phase": "kernel_check", "kernel": "mas", "oracle_row": row, "x_len": xl,
              "y_len": yl, "equal_to_numpy_oracle": ok})
        check(ok, f"mas disagrees with the numpy oracle on row {row}")

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in TRAIN_SHAPES + [(3, 5, 333, 64), (2, 6, 4000, 48)]:
        b, h, t, d = shape
        lengths = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
        lengths[0], lengths[-1] = 1, t
        valid = (torch.arange(t, device="cuda")[None] < lengths[:, None]).float()
        base = [torch.randn(shape, generator=gen, device="cuda") for _ in range(4)]
        ref_in = [x.clone().requires_grad_() for x in base[:3]]
        ref = torch.autograd.grad(att.masked_self_attention_plain(*ref_in, valid), ref_in, base[3])
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype).requires_grad_() for x in base[:3])
            out = att.masked_self_attention(q, k, v, valid)
            grads = torch.autograd.grad(out, (q, k, v), base[3].to(dtype))
            torch.cuda.synchronize()
            if dtype == torch.bfloat16:  # the reference at bf16-rounded inputs
                rin = [x.detach().float().requires_grad_() for x in (q, k, v)]
                r = torch.autograd.grad(att.masked_self_attention_plain(*rin, valid), rin,
                                        base[3].to(dtype).float())
            else:
                r = ref
            errs = {f"d{n}": ((g.float() - rr).abs().max() / rr.abs().max()).item()
                    for n, g, rr in zip("qkv", grads, r)}
            ok = all(np.isfinite(e) and e <= TOL[dtype] for e in errs.values())
            emit({"phase": "kernel_check", "kernel": "masked_attention_bwd", "shape": list(shape),
                  "dtype": str(dtype).split(".")[-1], "key_lengths": lengths.tolist()[:4],
                  "rel_err": errs, "tol": TOL[dtype], "ok": ok})
            check(ok, f"attention backward disagrees with autograd at {shape} {dtype}: {errs}")
            worst[dtype] = max(worst[dtype], *errs.values())
        del base, ref_in, ref, r, grads, out

    timed = {}
    for shape in TRAIN_SHAPES[:3:2]:  # the two buckets' T=512 / T=1088 decoder shapes
        b, h, t, d = shape
        q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                         for _ in range(4))
        valid = torch.ones((b, t), device="cuda")
        valid_u8 = valid.to(torch.uint8)
        out, lse = att._launch_fwd(q, k, v, valid_u8, with_lse=True)
        bwd_ms = cuda_ms(lambda: att.masked_attention_bwd_dkv(q, k, v, dout, lse, out, valid_u8))
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        plain_out = att.masked_self_attention_plain(qg, kg, vg, valid)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, (qg, kg, vg), dout, retain_graph=True))
        keep = valid[:, None, None, :] > 0
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
        library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout, retain_graph=True))
        timed[shape] = dict(bwd_entry(b, h, t, d, bwd_ms, library_ms), plain_ms=plain_ms,
                            earlier_ms=EARLIER_MS[shape])
        emit({"phase": "kernel_time", "kernel": "masked_attention_bwd", "shape": list(shape),
              "dtype": "bfloat16", "plain_and_library": "whole backward (dq, dk, dv)",
              "ms_includes": "the delta pre-pass, the fused pass and the dq post-pass",
              "earlier_ms": "the split pair (dk/dv kernel, then dq kernel) this pass replaced, PERF.md",
              **timed[shape]})
        del plain_out, lib_out

    for shape in MAS_SHAPES[:2]:
        b, tx, ty = shape
        value = torch.randn(shape, generator=gen, device="cuda") * 3.0
        x_len = torch.full((b,), tx, device="cuda")
        y_len = torch.full((b,), ty, device="cuda")
        ms = cuda_ms(lambda: mas.maximum_path_indices_kernel(value, x_len, y_len))
        plain_ms = cuda_ms(lambda: mas.maximum_path_indices_plain(value, x_len, y_len),
                           reps=3, per_rep=1, warmup=1)
        bound_ms, bound_by = mas_bound_ms(b, tx, ty)
        timed[shape] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                            bound_by=bound_by, sequential_frames=ty, ns_per_frame=ms * 1e6 / ty,
                            earlier_ms=MAS_EARLIER_MS.get(shape))
        emit({"phase": "kernel_time", "kernel": "mas", "shape": list(shape), **timed[shape]})
    return {"max_rel_err": worst, "timed": timed}


BWD_CHECK_SHAPES = [(62, 5, 512, 64), (29, 5, 1088, 64), (29, 5, 544, 64), (3, 5, 333, 64),
                    (2, 6, 4000, 48), (2, 3, 96, 36), (2, 3, 96, 40), (2, 4, 200, 128)]
# device times of the split pair (dk/dv kernel 179.65 / 335.47 µs, then dq
# kernel 120.10 / 225.50 µs) that the fused backward replaced, on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md's kernel table)
EARLIER_MS = {(62, 5, 512, 64): 0.29975, (29, 5, 1088, 64): 0.56097}


def bwd_entry(b, h, t, d, ms, library_ms) -> dict:
    """The backward's time (all its launches), its 5-product bound with q,
    k, v, dO read and dq, dk, dv written once (the benchmark's pair bound),
    its share of that bound, and SDPA's backward as ``library_ms``."""
    bound = attention_bwd_bound_ms(b, h, t, d, torch.bfloat16, t, products=5, tensors=8)
    return dict(ms=ms, bound_ms=bound[0], bound_by=bound[1], share_of_bound=bound[0] / ms,
                tflops=5 * 2 * b * h * t * t * d / (ms * 1e-3) / 1e12, library_ms=library_ms,
                vs_library=ms / library_ms)


def rel_err(got, ref) -> float:
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def check_bwd_alone(shape, dtype, gen, at="list", chunk=0) -> float:
    """The backward's launch alone at ``shape`` against
    ``masked_attention_bwd_plain``, fed the log-sum-exp the forward kernel
    wrote (itself held against ``masked_attention_lse_plain``) and delta by
    ``masked_attention_delta_plain``; ragged key lengths including 1, and
    with B > 2 batch row 1 with no valid key (its forward rows are NaN, 0 /
    0; the backward gets them as 0 and must give it zero gradients).  Keys
    past a row's length must get dk = dv = 0 exactly.  bf16: run twice, dk
    and dv must be equal bit for bit; dq is summed by fp32 reduce-adds that
    land in an order that changes from run to run, so the two dq may differ
    by a bf16 rounding step, and dq is held to the same TOL as dk and dv:
    its max |err| / max |ref| is bf16 output rounding (4e-3), which an fp32
    summation order moves by about 1e-7.  ``chunk`` > 0: chunk-causal, the
    forward's and the backward's.  Returns the worst max |err| / max |ref|
    of dq, dk, dv."""
    from matcha_tpu_torch.ops import attention as att

    b, h, t, d = shape
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    lengths[0], lengths[-1] = 1, t
    if b > 2:
        lengths[1] = 0
    valid = (torch.arange(t, device="cuda")[None] < lengths[:, None]).float()
    valid_u8 = valid.to(torch.uint8)
    padded = (valid_u8 == 0)[:, None, :, None].expand(b, h, t, d)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    out, lse = att._launch_fwd(q, k, v, valid_u8, with_lse=True, chunk=chunk)
    out = torch.nan_to_num(out, nan=0.0)
    dq, dk, dv = att.masked_attention_bwd_dkv(q, k, v, dout, lse, out, valid_u8, chunk=chunk)
    torch.cuda.synchronize()
    lse_ref = att.masked_attention_lse_plain(q, k, valid, chunk=chunk)
    finite = torch.isfinite(lse_ref)
    lse_err = (lse[finite] - lse_ref[finite]).abs().max().item()
    lse_err = lse_err if torch.equal(torch.isinf(lse), ~finite) else math.inf
    delta = att.masked_attention_delta_plain(dout, out)
    ref = att.masked_attention_bwd_plain(q.float(), k.float(), v.float(), dout.float(), lse, delta, valid,
                                         chunk=chunk)
    errs = {f"d{n}": rel_err(g, r) for n, g, r in zip("qkv", (dq, dk, dv), ref)}
    pad_zero = bool((dk[padded] == 0).all() and (dv[padded] == 0).all())
    empty_zero = bool(b <= 2 or all((g[1] == 0).all() for g in (dq, dk, dv)))
    rerun = {}
    if dtype == torch.bfloat16:
        dq2, dk2, dv2 = att.masked_attention_bwd_dkv(q, k, v, dout, lse, out, valid_u8, chunk=chunk)
        torch.cuda.synchronize()
        rerun = {"dk_dv_equal": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)),
                 "dq_rel_diff": rel_err(dq2, dq.float())}
    ok = (lse_err <= LSE_TOL and pad_zero and empty_zero
          and all(math.isfinite(e) and e <= TOL[dtype] for e in errs.values())
          and rerun.get("dk_dv_equal", True) and rerun.get("dq_rel_diff", 0.0) <= TOL[dtype])
    emit({"phase": "kernel_check", "kernel": "masked_attention_bwd_alone", "shape": list(shape),
          "dtype": str(dtype).split(".")[-1], "chunk": chunk, "shapes_from": at, "key_lengths": lengths.tolist()[:4],
          "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL, "rel_err": errs, "tol": TOL[dtype],
          "padded_keys_zero": pad_zero, "empty_row_zero": empty_zero, "rerun": rerun, "ok": ok})
    check(ok, f"the backward disagrees with masked_attention_bwd_plain at {shape} {dtype} chunk {chunk}: "
              f"lse {lse_err}, {errs}, padded keys zero: {pad_zero}, empty row zero: {empty_zero}, "
              f"rerun {rerun}")
    return max(errs.values())


def phase_bwd_kernels() -> dict:
    """``check_bwd_alone`` at the listed shapes, bf16 and fp32."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in BWD_CHECK_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            worst[dtype] = max(worst[dtype], check_bwd_alone(shape, dtype, gen))
    return worst


def phase_kernel_attributes() -> dict:
    """Registers, shared memory and local (spill) bytes of the bf16
    attention kernels, one instance per head-dim class (D <= 64,
    64 < D <= 128) and forward layout, and of the MAS kernels at the two
    training buckets and past the Tx boundary."""
    ext = kernels_ext()
    out = {f"bwd_d{d}": ext.masked_attention_bwd_attributes(d) for d in (64, 128)}
    out.update({f"fwd_layout{n}_d{d}": ext.masked_attention_fwd_attributes(n, d)
                for n in (1, 2) for d in (64, 128)})
    out.update({f"mas_{tx}x{ty}": ext.mas_attributes(tx, ty) for tx, ty in ((224, 1024), (448, 2176), (513, 700))})
    emit({"phase": "kernel_attributes", **out})
    return out


# p's change, mu and nu against the loop given the kernels' norm; the norm
# against the loop's own (fp32 squares summed in another order)
ADAMW_TOL = {"change": 1e-5, "mu": 1e-6, "nu": 1e-6, "norm": 1e-6}


def adamw_counters():
    from matcha_tpu_torch.ops import adamw

    return {"adamw_norm": adamw.adamw_norm_count, "adamw_update": adamw.adamw_update_count}


def max_rel(got: dict, ref: dict) -> float:
    """max |got − ref| over max |ref|, over every tensor of two name-keyed dicts."""
    diff = max(float((got[n] - ref[n]).abs().max()) for n in ref)
    scale = max(float(ref[n].abs().max()) for n in ref)
    return diff / scale if scale else diff


def phase_adamw() -> dict:
    """The multi-tensor AdamW (ops/adamw.py) against the plain loop
    (AdamW.apply_plain) on the card, at MatchaConfig()'s parameters.

    Four updates from the same weights and gradients on each side: one
    clipped (norm 10), one not (norm 1), one with a NaN (skipped), one at
    norm 3; four optimizers: the training recipe's, the fine-tune's
    trainable mask, an external norm (tensor parallelism's route) and two
    accumulated gradients (with the external norm).  Where the kernels take
    the norm themselves, the loop is given their norm, and their norm is
    held against the loop's own: one ulp of the norm moves p by one
    rounding, far more than 1e-5 of an update of about lr (the loop on its
    own norm is read beside, as ``own_norm``).  The fused updates run under
    ``torch.cuda.set_sync_debug_mode("error")``.  Then the update timed with
    CUDA events beside its bound, the plain loop and ``torch._fused_adamw_``
    (no clip, no norm), and five traced calls' device events by kernel."""
    import dataclasses

    from matcha_tpu_torch.finetune_speaker import trainable_mask_for_speaker
    from matcha_tpu_torch.models.config import MatchaConfig
    from matcha_tpu_torch.models.matcha import init_params
    from matcha_tpu_torch.train.optim import AdamW, OptimizerConfig, global_norm
    from matcha_tpu_torch.weights import decay_mask

    cfg = MatchaConfig()
    p0 = {n: t.to("cuda", torch.float32).contiguous()
          for n, t in init_params(cfg, torch.Generator().manual_seed(0)).items()}
    n_elems = sum(p.numel() for p in p0.values())
    gen = torch.Generator(device="cuda").manual_seed(17)

    def grads_at(norm: float, nan: bool = False) -> dict:
        g = {n: torch.randn(p.shape, generator=gen, device="cuda") for n, p in p0.items()}
        scale = norm / float(global_norm(g.values()))
        g = {n: t * scale for n, t in g.items()}
        if nan:
            g[next(iter(g))].view(-1)[0] = float("nan")
        return g

    steps = [grads_at(10.0), grads_at(1.0), grads_at(1.0, nan=True), grads_at(3.0)]
    opt_cfg = OptimizerConfig()

    def external(g):
        return global_norm(g.values())

    runs = {"recipe": (opt_cfg, None, None),
            "trainable_mask": (opt_cfg, trainable_mask_for_speaker(cfg), None),
            "external_norm": (opt_cfg, None, external),
            "accumulate_2": (dataclasses.replace(opt_cfg, accumulate_grad_batches=2), None, external)}
    counters = adamw_counters()
    report = {}
    for name, (ocfg, trainable, norm) in runs.items():
        sides = {}
        for side in ("fused", "plain", "own_norm"):
            opt = AdamW(ocfg, decay_mask(cfg), trainable, norm=norm)
            if side != "fused":
                opt._apply = opt.apply_plain
            params = {n: p.clone() for n, p in p0.items()}
            sides[side] = (opt, params, opt.init(params))
        per_step = []
        for i, grads in enumerate(steps):
            for c in counters.values():
                c.reset()
            torch.cuda.synchronize()
            opt, params, state = sides["fused"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                n_fused = opt.update(params, grads, state)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            applies = ocfg.accumulate_grad_batches == 1 or i % 2 == 1
            launched = {n: c.launches for n, c in counters.items()}
            opt, params, state = sides["plain"]
            if norm is None:
                opt.norm = lambda g, t=n_fused: t
            n_plain = opt.update(params, grads, state)
            opt, params, state = sides["own_norm"]
            n_own = opt.update(params, grads, state)
            torch.cuda.synchronize()
            (_, pf, sf), (_, pp, sp), (_, po, _) = sides["fused"], sides["plain"], sides["own_norm"]
            row = {"launches_ok": launched == {"adamw_norm": int(applies), "adamw_update": int(applies)},
                   "returns_ok": (n_fused is None) == (n_plain is None) == (n_own is None),
                   "change": max_rel({n: pf[n] - p0[n] for n in p0}, {n: pp[n] - p0[n] for n in p0}),
                   "mu": max_rel(sf.mu, sp.mu), "nu": max_rel(sf.nu, sp.nu), "norm": 0.0,
                   "own_norm_change": max_rel({n: pf[n] - p0[n] for n in p0}, {n: po[n] - p0[n] for n in p0}),
                   "scalars_equal": all(int(getattr(sf, k)) == int(getattr(sp, k)) for k in
                                        ("count", "notfinite_count", "last_finite", "total_notfinite"))}
            if n_fused is not None:
                fused_v, own_v = float(n_fused), float(n_own)
                row["norm"] = (abs(fused_v - own_v) / own_v if math.isfinite(own_v)
                               else float(math.isfinite(fused_v)))
            per_step.append(row)
        report[name] = {"steps": per_step, "count": int(sides["fused"][2].count),
                        "max_rel": {k: max(r[k] for r in per_step) for k in ADAMW_TOL}}
    emit({"phase": "adamw_readings", "runs": report})
    for name, r in report.items():
        for i, row in enumerate(r["steps"]):
            check(row["launches_ok"] and row["returns_ok"], f"adamw {name} step {i}: launches or returned norm")
            check(row["scalars_equal"], f"adamw {name} step {i}: count, notfinite_count, last_finite "
                                        "or total_notfinite differ")
        for k, tol in ADAMW_TOL.items():
            check(r["max_rel"][k] <= tol, f"adamw {name}: {k} differs by {r['max_rel'][k]:.3g} relative "
                                          f"(limit {tol})")
    # recipe: steps 0, 1 and 3 applied; accumulated: (0, 1) applied, (2, 3) holds the NaN
    check(report["recipe"]["count"] == 3 and report["accumulate_2"]["count"] == 1,
          f"adamw: step counts {report['recipe']['count']}, {report['accumulate_2']['count']}")

    # the wrapper refuses what the kernels cannot take
    opt = AdamW(opt_cfg, decay_mask(cfg))
    params = {n: p.clone() for n, p in p0.items()}
    state = opt.init(params)
    first = next(iter(p0))
    refused = {}
    for what, bad in (("cpu_grad", steps[1][first].cpu()),
                      ("strided_grad", torch.zeros(2 * p0[first].numel(), device="cuda")[::2].view(p0[first].shape)),
                      ("bf16_grad", steps[1][first].bfloat16())):
        try:
            opt.update(params, {**steps[1], first: bad}, state)
            refused[what] = False
        except ValueError:
            refused[what] = True
    check(all(refused.values()), f"adamw: the wrapper took {refused}")

    # time: the kernels (one wrapper call) against the bound, the loop and torch._fused_adamw_
    opt = AdamW(opt_cfg, decay_mask(cfg))
    params = {n: p.clone() for n, p in p0.items()}
    state = opt.init(params)
    grads = steps[1]
    fused_ms = cuda_ms(lambda: opt.update(params, grads, state))
    plain = AdamW(opt_cfg, decay_mask(cfg))
    pparams = {n: p.clone() for n, p in p0.items()}
    pstate = plain.init(pparams)
    plain_ms = cuda_ms(lambda: plain.apply_plain(pparams, grads, pstate), reps=5, per_rep=1, warmup=1)
    lib = [list(pparams.values()), list(grads.values()), list(pstate.mu.values()), list(pstate.nu.values())]
    lib_steps = [torch.ones((), device="cuda") for _ in lib[0]]
    library_ms = cuda_ms(lambda: torch._fused_adamw_(
        *lib, [], lib_steps, lr=opt_cfg.lr, beta1=opt_cfg.b1, beta2=opt_cfg.b2,
        weight_decay=opt_cfg.weight_decay, eps=opt_cfg.eps, amsgrad=False, maximize=False))
    traced = device_breakdown(lambda: [opt.update(params, grads, state) for _ in range(5)],
                              kernels=("adamw_norm_partials", "adamw_norm_finish", "adamw_update"))
    bound_ms = 32 * n_elems / PEAK_BYTES * 1e3  # update 28 B an element, norm 4
    out = {"phase": "adamw", "leaves": len(p0), "elements": n_elems,
           "chunks": int(opt.fused._chunks.shape[0]), "tolerance": ADAMW_TOL,
           "runs": {name: {"max_rel": r["max_rel"], "count": r["count"],
                           "own_norm_change": max(row["own_norm_change"] for row in r["steps"])}
                    for name, r in report.items()},
           "sync_debug": "error (no sync raised)", "refused": refused,
           "ms": fused_ms, "bound_ms": bound_ms, "bound_by": "bytes",
           "update_bound_ms": 28 * n_elems / PEAK_BYTES * 1e3, "plain_ms": plain_ms,
           "plain_note": "device time of the loop's 9.7 k launches, paced by the host",
           "library_ms": library_ms, "library": "torch._fused_adamw_ (no clip, no norm)",
           "traced_5_calls": {"device_events": traced["device_events"], "busy_ms": traced["device_busy_ms"],
                              "kernels": traced["kernels"]}}
    emit(out)
    del p0, steps, params, pparams, lib
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the DiT's fused glue (ops/dit_fused.py, csrc/dit_fused.cu)
# ---------------------------------------------------------------------------

# (B, N) of the f5-train mix: its longest bucket, a middle one, its shortest
DIT_FUSED_SHAPES = [(13, 2848), (52, 736), (240, 160)]
DIT_FUSED_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # max |err| / max |ref|
# f5-train's judge (benchmark/workloads/f5-train.json): the fused bf16 step against the plain fp32 one
DIT_STEP_LIMITS = {"loss_gap": 0.002, "grad_gap": 0.01}
DIT_STEP_SEED = 11  # its step 0 drops neither the audio nor the text


def dit_fused_bytes(b: int, n: int, c: int, w: int, hd: int, d: int) -> dict:
    """Least bytes of each wrapper call: every input read once, every
    output written once (bf16 narrow operands, fp32 carry and uniforms, a
    bit a dropout element, a byte a row mask); the partials left out."""
    rows, elems, wide = b * n, b * n * c, b * n * w
    vec = 4 * b * c
    return {"modulate_fwd": elems * (4 + 2) + 8 * rows + 2 * vec,
            "modulate_bwd": elems * (2 + 4 + 4) + 8 * rows + vec + 2 * vec,
            "rope_heads_fwd": 3 * 2 * 2 * b * n * hd + 4 * n * d,
            "rope_heads_bwd": 3 * 2 * 2 * b * n * hd + 4 * n * d,
            "gated_residual_fwd_attn": elems * (4 + 2 + 4 + 4) + elems // 8 + rows + vec,
            "gated_residual_bwd_attn": elems * (4 + 2 + 2) + elems // 8 + rows + 2 * vec,
            "gated_residual_fwd_ff": elems * (4 + 2 + 4) + vec,
            "gated_residual_bwd_ff": elems * (4 + 2 + 2) + 2 * vec,
            "gelu_dropout_fwd": wide * (2 + 4 + 2) + wide // 8,
            "gelu_dropout_bwd": wide * (2 + 2 + 2) + wide // 8}


def dit_fused_checks(b: int, n: int, cfg, gen) -> dict:
    """Every fused kernel, forward and backward, against its plain version
    at (B, N): max |err| / max |ref| of each output (the bits exactly), a
    synchronize after the launches, then each call's device time beside its
    plain version's and its byte bound."""
    from matcha_tpu_torch.models import dit
    from matcha_tpu_torch.ops import dit_fused as fz

    c, hd, d, w, p = cfg.dim, cfg.heads * cfg.dim_head, cfg.dim_head, cfg.dim * cfg.ff_mult, dit.DROPOUT
    bf16 = torch.bfloat16

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    lengths = torch.randint(1, n + 1, (b,), generator=gen, device="cuda")
    lengths[-1] = n
    keep = torch.arange(n, device="cuda")[None] < lengths[:, None]
    h = rnd(b, n, c, scale=3.0) + 1.0
    sh, sc, g = rnd(b, 1, 6 * c, scale=0.5).chunk(6, dim=-1)[:3]
    rope = dit._table("rope", d, n, "cuda")
    q, k, v, y = (rnd(b, n, hd, dtype=bf16) for _ in range(4))
    heads_grads = [rnd(b, cfg.heads, n, d, dtype=bf16) for _ in range(3)]
    dy, dout = rnd(b, n, c, dtype=bf16), rnd(b, n, c)
    x, dyw = rnd(b, n, w, dtype=bf16, scale=2.0), rnd(b, n, w, dtype=bf16)
    u = torch.rand((b, n, c), generator=gen, device="cuda")
    uw = torch.rand((b, n, w), generator=gen, device="cuda")
    _, mean, rstd = fz.modulate_fwd_plain(h, sc, sh, bf16, dit.LN_EPS)

    calls = {  # name → (kernel call, plain call)
        "modulate_fwd": (lambda: fz.modulate_fwd(h, sc, sh, bf16, dit.LN_EPS),
                         lambda: fz.modulate_fwd_plain(h, sc, sh, bf16, dit.LN_EPS)),
        "modulate_bwd": (lambda: fz.modulate_bwd(dy, h, sc, mean, rstd),
                         lambda: fz.modulate_bwd_plain(dy, h, sc, mean, rstd)),
        "rope_heads_fwd": (lambda: fz.rope_heads_fwd(q, k, v, rope, cfg.heads),
                           lambda: fz.rope_heads_plain(q, k, v, rope, cfg.heads)),
        "rope_heads_bwd": (lambda: fz.rope_heads_bwd(*heads_grads, rope, cfg.heads),
                           lambda: fz.rope_heads_plain(*heads_grads, rope, cfg.heads, backward=True)),
        "gated_residual_fwd_attn": (lambda: fz.gated_residual_fwd(h, g, y, u, keep, p),
                                    lambda: fz.gated_residual_fwd_plain(h, g, y, u, keep, p)),
        "gated_residual_fwd_ff": (lambda: fz.gated_residual_fwd(h, g, y, None, None, 0.0),
                                  lambda: fz.gated_residual_fwd_plain(h, g, y, None, None, 0.0)),
        "gelu_dropout_fwd": (lambda: fz.gelu_dropout_fwd(x, uw, p), lambda: fz.gelu_dropout_fwd_plain(x, uw, p)),
    }
    _, bits = fz.gated_residual_fwd_plain(h, g, y, u, keep, p)
    _, bits_w = fz.gelu_dropout_fwd_plain(x, uw, p)
    calls["gated_residual_bwd_attn"] = (lambda: fz.gated_residual_bwd(dout, g, y, bits, keep, p),
                                        lambda: fz.gated_residual_bwd_plain(dout, g, y, bits, keep, p))
    calls["gated_residual_bwd_ff"] = (lambda: fz.gated_residual_bwd(dout, g, y, None, None, 0.0),
                                      lambda: fz.gated_residual_bwd_plain(dout, g, y, None, None, 0.0))
    calls["gelu_dropout_bwd"] = (lambda: fz.gelu_dropout_bwd(dyw, x, bits_w, p),
                                 lambda: fz.gelu_dropout_bwd_plain(dyw, x, bits_w, p))

    errors = {}
    for name, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()  # a launch that faulted shows here
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        worst = 0.0
        for a, r in zip(got, want):
            if r is None:
                check(a is None, f"dit_fused {name} at {(b, n)}: an output the plain version lacks")
            elif r.dtype == torch.uint8:
                check(torch.equal(a, r), f"dit_fused {name} at {(b, n)}: the dropout bits differ")
            else:
                check(a.shape == r.shape and a.dtype == r.dtype, f"dit_fused {name}: {a.shape} {a.dtype}")
                err = rel_err(a, r.float())
                check(err <= DIT_FUSED_TOL[r.dtype], f"dit_fused {name} at {(b, n)}: error {err}")
                worst = max(worst, err)
        errors[name] = worst
    nbytes = dit_fused_bytes(b, n, c, w, hd, d)
    timed = {}
    for name, (kernel, plain) in calls.items():
        bound = nbytes[name] / PEAK_BYTES * 1e3
        ms = cuda_ms(kernel)
        timed[name] = {"ms": ms, "bound_ms": bound, "of_bound": bound / ms, "plain_ms": cuda_ms(plain)}
    return {"errors": errors, "timed": timed}


def phase_dit_fused() -> dict:
    """The DiT's fused glue kernels: each against its plain version and
    timed at ``DIT_FUSED_SHAPES`` (``dit_fused_checks``); then one whole
    DiT step (F5-TTS v1 Base, bf16, 13 × 2848) against the plain fp32
    reference (``tests/plain_f5tts.py``, TF32 off) on the same draws and
    dropout masks: the loss and every leaf's gradient norm within f5-train's
    judge limits, the fused kernels' launches counted exactly."""
    import dataclasses
    import importlib.util

    from torch.func import functional_call

    from matcha_tpu_torch.models import dit
    from matcha_tpu_torch.models.config import DiTConfig
    from matcha_tpu_torch.ops import dit_fused as fz
    from matcha_tpu_torch.utils.profile_step import synthetic_batch

    cfg = DiTConfig()
    gen = torch.Generator(device="cuda").manual_seed(23)
    shapes = {}
    for b, n in DIT_FUSED_SHAPES:
        shapes[f"{b}x{n}"] = dit_fused_checks(b, n, cfg, gen)
        emit({"phase": "dit_fused", "shape": [b, n], "width": cfg.dim, **shapes[f"{b}x{n}"]})
        torch.cuda.empty_cache()

    spec = importlib.util.spec_from_file_location("plain_f5tts", os.path.join(ROOT, "tests", "plain_f5tts.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    params = dit.init_params(cfg, torch.Generator().manual_seed(0))
    batch = synthetic_batch(cfg, 13, 448, 2848).to("cuda")
    inputs = {"x": batch.x, "x_lengths": batch.x_lengths, "y": batch.y, "y_lengths": batch.y_lengths,
              "weights": torch.ones(13, device="cuda")}
    drop_audio, drop_text = ref.drops(DIT_STEP_SEED, 0)

    model = dit.F5TTS(cfg).cuda()
    live = {k: v.cuda().requires_grad_() for k, v in params.items()}
    for counter in fz.COUNTERS:
        counter.reset()
    losses = functional_call(
        model, live, (batch.x, batch.x_lengths, batch.y, batch.y_lengths,
                      torch.Generator(device="cuda").manual_seed(ref.step_seed(DIT_STEP_SEED, 0))),
        {"drop_audio": drop_audio, "drop_text": drop_text, "row_weights": inputs["weights"],
         "dropout_generator": torch.Generator(device="cuda").manual_seed(ref.step_seed(DIT_STEP_SEED, 0, 0, 2))})
    grads = torch.autograd.grad(losses["loss"], list(live.values()))
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in fz.COUNTERS}
    fused = {"loss": float(losses["loss"].detach()), "norms": {n: float(g.float().norm()) for n, g in zip(live, grads)}}
    del model, live, losses, grads
    torch.cuda.empty_cache()

    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        plain = ref.F5TTS(dataclasses.asdict(cfg)).cuda()
        plain.load_state_dict(params)
        loss = ref.losses(plain, inputs, DIT_STEP_SEED, 0)["loss"]
        grads = torch.autograd.grad(loss, [plain.get_parameter(n) for n in params])
        want = {"loss": float(loss.detach()), "norms": {n: float(g.norm()) for n, g in zip(params, grads)}}
        del plain, loss, grads
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()

    loss_gap = abs(fused["loss"] - want["loss"]) / abs(want["loss"])
    med = statistics.median(want["norms"].values())
    gaps = {name: abs(fused["norms"][name] - r) / max(r, med, 1e-30) for name, r in want["norms"].items()}
    worst = sorted(gaps, key=gaps.get, reverse=True)[:4]
    depth = cfg.depth
    expected = {"dit_modulate_fwd": 2 * depth + 1, "dit_modulate_bwd": 2 * depth + 1,
                "dit_rope_heads_fwd": depth, "dit_rope_heads_bwd": depth,
                "dit_gated_residual_fwd": 2 * depth, "dit_gated_residual_bwd": 2 * depth,
                "dit_gelu_dropout_fwd": depth, "dit_gelu_dropout_bwd": depth}
    out = {"phase": "dit_fused_step", "batch": [13, 2848], "drops": [drop_audio, drop_text],
           "loss": {"fused": fused["loss"], "plain_fp32": want["loss"]}, "loss_gap": loss_gap,
           "grad_gap": gaps[worst[0]], "worst_leaves": [[n, gaps[n]] for n in worst], "limits": DIT_STEP_LIMITS,
           "launches": launches, "expected_launches": expected}
    emit(out)
    check(loss_gap <= DIT_STEP_LIMITS["loss_gap"], f"dit_fused_step: loss_gap {loss_gap}")
    check(gaps[worst[0]] <= DIT_STEP_LIMITS["grad_gap"], f"dit_fused_step: grad_gap {gaps[worst[0]]} ({worst[0]})")
    check(launches == expected, f"dit_fused_step: launches {launches}, expected {expected}")
    return {"shapes": shapes, "step": out}

def write_corpus(root, n_feats: int, seed: int = 0):
    """~62 utterances with coarse lengths 490-512 (bucket 512, B=62) and 29
    with 1000-1088 (bucket 1088, B=29), about 5 fine frames per token,
    speakers 0-15; channel-major coarse and fine .npy mels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mel_dir = os.path.join(root, "mels")
    os.makedirs(os.path.join(mel_dir, "s"), exist_ok=True)
    rows = []
    lengths = [int(n) for n in rng.integers(490, 513, 62)] + [int(n) for n in rng.integers(1000, 1089, 29)]
    for i, frames in enumerate(lengths):
        rel = f"s/u{i:03d}"
        fine = rng.standard_normal((n_feats, 2 * frames)).astype(np.float32)
        coarse = fine[:, ::2] * 0.5 + fine[:, 1::2] * 0.5
        np.save(os.path.join(mel_dir, f"{rel}.npy"), coarse)
        np.save(os.path.join(mel_dir, f"{rel}.fine.npy"), fine)
        ids = " ".join(str(v) for v in rng.integers(1, 600, (2 * frames) // 5))
        rows.append(f"{rel}|{i % 16}|en-us|utterance {i}|{ids}")
    with open(os.path.join(mel_dir, "metadata.json"), "w") as f:
        f.write('{"n_mels": %d}' % n_feats)
    filelist = os.path.join(root, "train.csv")
    with open(filelist, "w") as f:
        f.write("\n".join(rows))
    return filelist, mel_dir


def train_counters():
    from matcha_tpu_torch.ops import attention as att
    from matcha_tpu_torch.ops import mas

    return {"masked_attention_fwd": att.masked_attention_fwd_count,
            "masked_attention_bwd": att.masked_attention_bwd_count,
            "mas": mas.mas_count}


# every signature (shapes, dtype, lse, chunk) at which a main path launched each
# kernel, gathered by read_counts and checked by phase_path_signatures
LAUNCHED: dict[str, set] = {}


def read_counts(counters) -> dict:
    """The launches since the counts were set to 0; each kernel's launch
    signatures join ``LAUNCHED``."""
    for n, c in counters.items():
        LAUNCHED.setdefault(n, set()).update(c.signatures)
    return {n: c.launches for n, c in counters.items()}


def unet_launches(cfg) -> int:
    """K1 launches of one U-Net evaluation: one per decoder transformer
    block (12 at production widths)."""
    dec = cfg.decoder
    return dec.n_blocks * (2 * len(dec.channels) + dec.num_mid_blocks)


def request_launches(cfg) -> int:
    """K1 launches of one served request: the encoder's layers plus the
    decoder's transformer blocks in each of the 8 U-Net evaluations of
    midpoint/4 (4 + 8 x 12 = 100 at production widths)."""
    return cfg.encoder.n_layers + 8 * unet_launches(cfg)


def step_launches(cfg, deterministic: bool = False) -> dict:
    """Launches of one training step: K1 and K1b once per decoder
    transformer block, and once per encoder layer when the encoder
    has no dropout or the step is deterministic (with dropout its attention
    takes the plain path); MAS once."""
    n_attn = unet_launches(cfg)
    if cfg.encoder.p_dropout == 0.0 or deterministic:
        n_attn += cfg.encoder.n_layers
    return {"masked_attention_fwd": n_attn, "masked_attention_bwd": n_attn, "mas": 1}


def bf16_train_config():
    """Full-width MatchaConfig in the configs/experiment/bf16.yaml regime."""
    import dataclasses

    from matcha_tpu_torch.models.config import MatchaConfig

    return dataclasses.replace(MatchaConfig(), compute_dtype="bfloat16")


def phase_train(tmp: str) -> dict:
    """The training path through its entry points: a Trainer over a
    synthetic corpus at full width, bf16, both buckets at least twice; then
    its checkpoint served by load_synthesizer."""
    import numpy as np

    from matcha_tpu_torch.checkpoint import load_synthesizer
    from matcha_tpu_torch.data.dataset import TextMelDataset
    from matcha_tpu_torch.train.optim import OptimizerConfig
    from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = bf16_train_config()
    filelist, mel_dir = write_corpus(tmp, cfg.n_feats)
    counters = train_counters()
    opt_counters = adamw_counters()
    tcfg = TrainerConfig(output_dir=os.path.join(tmp, "run"), max_epochs=-1, log_every_n_steps=1,
                         checkpoint_every_n_epochs=100, seed=1234)
    trainer = Trainer(cfg, OptimizerConfig(), tcfg, TextMelDataset(filelist, mel_dir),
                      max_frames_per_batch=32000, len_bucket=32)
    records = []
    real_step = trainer.train_step

    def timed_step(state, batch, seed):
        torch.cuda.synchronize()
        before = {n: c.launches for n, c in counters.items()}
        opt_before = {n: c.launches for n, c in opt_counters.items()}
        t0 = time.perf_counter()
        state, metrics = real_step(state, batch, seed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        real_frames = int((batch.y_lengths.float() * batch.weights).sum())
        records.append({"step": state.step, "batch": list(batch.y.shape[:2]),
                        "text_bucket": batch.x.shape[1], "seconds": seconds,
                        "coarse_frames": real_frames,
                        "launches": {n: c.launches - before[n] for n, c in counters.items()},
                        "optimizer_launches": {n: c.launches - opt_before[n] for n, c in opt_counters.items()},
                        **{k: float(v) for k, v in metrics.items()}})
        emit({"phase": "train_step", **records[-1]})
        return state, metrics

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    try:
        state = trainer.fit(max_steps=6)
    finally:
        trainer.close()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    by_bucket = {}
    for r in records:
        by_bucket.setdefault(tuple(r["batch"]), []).append(r)
    check(set(by_bucket) == {(62, 512), (29, 1088)}, f"buckets {sorted(by_bucket)}")
    check(all(len(v) >= 2 for v in by_bucket.values()), "each bucket must run at least twice")
    for r in records:
        finite = all(math.isfinite(r[k]) for k in ("loss", "sub_loss/diff", "sub_loss/dur",
                                                    "sub_loss/prior", "grad_norm"))
        check(finite, f"non-finite metrics at step {r['step']}")
        want = step_launches(cfg)
        check(r["launches"] == want, f"step {r['step']} launched {r['launches']}, expected {want}")
        check(r["optimizer_launches"] == {"adamw_norm": 1, "adamw_update": 1},
              f"step {r['step']}: the fused AdamW ran {r['optimizer_launches']}")
    summary = {}
    for (b, t), rs in sorted(by_bucket.items()):
        steady = rs[1:]  # the first step of a bucket builds cuDNN plans and allocator pools
        med = statistics.median(r["seconds"] for r in steady)
        summary[f"B{b}_T{t}"] = {
            "steps": len(rs), "median_step_s": med, "first_step_s": rs[0]["seconds"],
            "text_bucket": rs[0]["text_bucket"],
            "coarse_frames_per_s": statistics.median(r["coarse_frames"] / r["seconds"] for r in steady),
        }
    ckpts = sorted(glob.glob(os.path.join(tmp, "run", "checkpoints", "epoch_*")))
    check(bool(ckpts), "the trainer wrote no checkpoint")
    synth = load_synthesizer(ckpts[-1], device="cuda")
    ids = ids_of(120, 21)
    res = synth.synthesise_ids(ids, scale_correction=1.0, debug=True)
    check(res.mel is not None and res.mel.shape[1] == cfg.n_feats and res.mel.shape[0] > 0
          and bool(np.isfinite(res.mel).all()), "served checkpoint gave no finite mel")
    out = {"phase": "train", "compute_dtype": cfg.compute_dtype, "steps": state.step,
           "weights": "random (seeded torch.Generator)", "buckets": summary,
           "peak_memory_gib": peak_gb, "launches_per_step": records[-1]["launches"],
           "checkpoint": os.path.relpath(ckpts[-1], tmp),
           "served_request": {"tokens": len(ids), "mel_frames": int(res.mel.shape[0]),
                              "latency_ms": res.latency_s * 1e3}}
    emit(out)
    del synth, trainer, state
    torch.cuda.empty_cache()
    return out


def fixed_batch(tmp: str, cfg, b: int, dev: str = "cuda", offset: int = 0):
    """``b`` of the 62 utterances of the 512 bucket, from the ``offset``-th
    on (cyclically), collated, on the card."""
    from matcha_tpu_torch.data.collate import collate
    from matcha_tpu_torch.data.dataset import TextMelDataset
    from matcha_tpu_torch.data.sampler import BucketPlan

    ds = TextMelDataset(os.path.join(tmp, "train.csv"), os.path.join(tmp, "mels"), cfg.n_feats)
    indices = [(offset + i) % 62 for i in range(b)]
    return collate(ds, BucketPlan(mel_len=512, batch_size=b, indices=indices, n_real=b),
                   text_bucket=32).to(dev)


def fixed_t_noise(batch, seed: int = 5):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = batch.y.shape[0]
    t = torch.rand((b, 1, 1), generator=gen, device="cuda") * 0.9 + 0.05
    return t, torch.randn(batch.y.shape, generator=gen, device="cuda")


def phase_train_learns(tmp: str) -> dict:
    """20 steps on one fixed B=4 batch, deterministic, fixed t and noise, lr
    1e-3: a kernel with zero or wrong gradients would not bring it down."""
    from matcha_tpu_torch.train.optim import OptimizerConfig
    from matcha_tpu_torch.train.step import TrainStep

    cfg = bf16_train_config()
    ts = TrainStep(cfg, OptimizerConfig(lr=1e-3), device="cuda")
    state = ts.init_state(generator=torch.Generator().manual_seed(7))
    batch = fixed_batch(tmp, cfg, 4)
    t_noise = fixed_t_noise(batch)
    names = ("loss", "sub_loss/diff", "sub_loss/dur", "sub_loss/prior")
    history = {n: [] for n in names}
    for _ in range(20):
        state, m = ts.train_step(state, batch, 0, deterministic=True, cfm_t_noise=t_noise)
        for n in names:
            history[n].append(float(m[n]))
    losses = history["loss"]
    drop = 1.0 - losses[-1] / losses[0]
    # each sub-loss: the mean of the last 5 steps below that of the first 5
    sub_drops = {n: 1.0 - statistics.mean(h[-5:]) / statistics.mean(h[:5]) for n, h in history.items()
                 if n != "loss"}
    out = {"phase": "train_learns", "batch": list(batch.y.shape[:2]), "losses": losses,
           "sub_losses": {n: history[n] for n in sub_drops}, "relative_drop": drop,
           "sub_loss_relative_drop": sub_drops, "required": 0.10}
    emit(out)
    check(all(math.isfinite(x) for h in history.values() for x in h) and drop >= 0.10,
          f"the loss fell {drop:.3f} in 20 steps, less than 10 %")
    for n, d in sub_drops.items():
        check(d > 0, f"{n} did not fall in 20 steps: last-5 mean {d:+.3f} against the first 5")
    return out


def phase_train_reference(tmp: str) -> dict:
    """fp32 at full width on a small batch: losses and every gradient of the
    kernel path (K1/K1b attention, MAS kernel) against the plain path
    (einsum attention, scan MAS), same weights, deterministic."""
    import dataclasses

    from matcha_tpu_torch.models.config import MatchaConfig
    from matcha_tpu_torch.models.matcha import MatchaTTS, init_params

    params = init_params(MatchaConfig(), torch.Generator().manual_seed(11))
    batch = fixed_batch(tmp, MatchaConfig(), 2)
    t_noise = fixed_t_noise(batch, seed=6)
    runs = {}
    for name, attention, mas_backend in (("kernel", "auto", "auto"), ("plain", "einsum", "scan")):
        cfg = dataclasses.replace(MatchaConfig(), attention_backend=attention, mas_backend=mas_backend)
        model = MatchaTTS(cfg).cuda()
        model.load_state_dict(params)
        losses = model.compute_losses(*batch[:7], deterministic=True, cfm_t_noise=t_noise)
        losses["loss"].backward()
        runs[name] = ({k: float(losses[k]) for k in ("loss", "diff_loss", "dur_loss", "prior_loss")},
                      {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None})
        del model, losses
    (lk, gk), (lp, gp) = runs["kernel"], runs["plain"]
    loss_err = max(abs(lk[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lk)
    check(set(gk) == set(gp), "the two paths reach different parameters")
    grad_err = {n: ((gk[n] - gp[n]).abs().max() / gp[n].abs().max().clamp_min(1e-30)).item() for n in gp}
    worst = max(grad_err, key=grad_err.get)
    out = {"phase": "train_reference", "compute_dtype": "float32", "batch": list(batch.y.shape[:2]),
           "losses_kernel": lk, "losses_plain": lp, "loss_rel_err": loss_err, "loss_tol": 1e-4,
           "grad_rel_err_max": grad_err[worst], "grad_worst_param": worst, "grad_tol": 1e-3,
           "params_compared": len(grad_err)}
    emit(out)
    check(loss_err <= 1e-4, f"kernel and plain losses differ by {loss_err}")
    check(grad_err[worst] <= 1e-3, f"gradient of {worst} differs by {grad_err[worst]}")
    return out


def phase_train_profile(tmp: str) -> dict:
    """One full-width bf16 B=62 training step under torch.profiler."""
    from matcha_tpu_torch.train.optim import OptimizerConfig
    from matcha_tpu_torch.train.step import TrainStep

    cfg = bf16_train_config()
    ts = TrainStep(cfg, OptimizerConfig(), device="cuda")
    state = ts.init_state(generator=torch.Generator().manual_seed(3))
    batch = fixed_batch(tmp, cfg, 62)
    ts.train_step(state, batch, 0)  # warm-up: cuDNN plans, allocator
    out = {"phase": "train_profile", "batch": list(batch.y.shape[:2]),
           "step": device_breakdown(lambda: ts.train_step(state, batch, 0),
                                    kernels=("masked_attention_fwd", "attn_bwd_dq", "attn_bwd_dkv",
                                             "mas_kernel"))}
    emit(out)
    del ts, state
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the voice-building tools: mel frontend, corpus prep, speaker fine-tune,
# StyleEncoder training, add-speaker, synthesis CLI and MCD
# ---------------------------------------------------------------------------

MEL_TOL = 2e-3  # log-mel against the independent float64 reference
FINETUNE_SPEAKER = 5
NEW_SPEAKER = 16


def recordings() -> list[str]:
    paths = sorted(glob.glob(os.path.join(ROOT, "mcd_validation", "original_speaker_*.wav")))
    check(len(paths) == 10, f"expected the ten mcd_validation recordings, found {len(paths)}")
    return paths


def mel_reference(wav, cfg):
    """float64 numpy log-mel, independent of the port's extractor: centred
    reflect-padded frames, the periodic Hann window, rfft magnitude, an HTK
    triangular filterbank (torchaudio's ``melscale_fbanks(norm=None)``),
    log(max(·, eps)).  The window and the filterbank are rounded to float32
    and taken back to float64, as torchaudio and the JAX package keep them:
    exact values would leak the loud bins into the faint ones by ~3e-4 in
    log."""
    import numpy as np

    check(cfg.mel_scale == "htk", f"the reference builds HTK filterbanks only, not {cfg.mel_scale}")
    hop, n_fft = cfg.hop_length, cfg.n_fft
    t = (len(wav) // hop) * hop
    y = np.pad(wav[:t].astype(np.float64), n_fft // 2, mode="reflect")
    idx = np.arange(1 + t // hop)[:, None] * hop + np.arange(n_fft)[None, :]
    window = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)).astype(np.float32).astype(np.float64)
    mag = np.abs(np.fft.rfft(y[idx] * window, axis=-1))
    hz = np.linspace(0.0, cfg.sample_rate / 2, n_fft // 2 + 1)
    mel_max, mel_min = (2595.0 * np.log10(1.0 + f / 700.0) for f in (cfg.f_max, cfg.f_min))
    corners = 700.0 * (10.0 ** (np.linspace(mel_min, mel_max, cfg.n_mels + 2) / 2595.0) - 1.0)
    lo, mid, hi = corners[:-2], corners[1:-1], corners[2:]
    fb = np.maximum(0.0, np.minimum((hz[:, None] - lo) / (mid - lo), (hi - hz[:, None]) / (hi - mid)))
    return np.log(np.maximum(mag @ fb.astype(np.float32).astype(np.float64), cfg.log_eps))


def phase_mel_frontend() -> dict:
    """Coarse and fine log-mel of the ten recordings on the card against the
    float64 reference; then ``precompute_mels.extract_pair`` (host wav →
    card → both normalized mels → host) timed over the ten."""
    import numpy as np

    from matcha_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
    from matcha_tpu_torch.utils.audio_io import read_wav
    from matcha_tpu_torch.utils.precompute_mels import extract_pair

    wavs = [read_wav(p)[0] for p in recordings()]
    worst = 0.0
    for wav in wavs:
        for cfg in (MelConfig(), MelConfig().fine):
            got = log_mel_spectrogram(torch.from_numpy(wav).cuda(), cfg).cpu().numpy()
            want = mel_reference(wav, cfg)
            check(got.shape == want.shape == (1 + len(wav) // cfg.hop_length, cfg.n_mels),
                  f"log-mel shape {got.shape}, reference {want.shape}")
            worst = max(worst, float(np.abs(got - want).max()))
    check(worst <= MEL_TOL, f"log-mel on the card is {worst} from the float64 reference")
    audio_s = sum(len(w) for w in wavs) / 24000
    extract_pair(wavs[0], MelConfig(), -4.68, 6.51, "cuda")  # cuFFT plans
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for wav in wavs:
            extract_pair(wav, MelConfig(), -4.68, 6.51, "cuda")
        walls.append(time.perf_counter() - t0)
    out = {"phase": "mel_frontend", "recordings": len(wavs), "audio_s": audio_s,
           "max_abs_err_vs_float64": worst, "tol": MEL_TOL,
           "extract_pair_wall_s": walls, "audio_s_per_wall_s": audio_s / statistics.median(walls)}
    emit(out)
    return out


def phase_corpus_prep(tmp: str, counters) -> dict:
    """wavs → generate_data_statistics → precompute_mels (the port's CLIs,
    on the card) → TextMelDataset → one Trainer step at full width, bf16."""
    import contextlib
    import shutil

    import numpy as np

    from matcha_tpu_torch.data.dataset import TextMelDataset
    from matcha_tpu_torch.train.optim import OptimizerConfig
    from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig
    from matcha_tpu_torch.utils import generate_data_statistics, precompute_mels
    from matcha_tpu_torch.utils.audio_io import read_wav

    wav_dir = os.path.join(tmp, "rec_wavs")
    os.makedirs(os.path.join(wav_dir, "rec"))
    rng = np.random.default_rng(3)
    rows = []
    for i, path in enumerate(recordings()):
        rel = f"rec/{os.path.basename(path)[:-4]}"
        shutil.copy(path, os.path.join(wav_dir, rel + ".wav"))
        fine = 2 * (1 + len(read_wav(path)[0]) // 256) - 1
        ids = " ".join(str(v) for v in rng.integers(1, 600, fine // 5))
        rows.append(f"{rel}|{i}|en-us|recording {i}|{ids}")
    filelist = os.path.join(tmp, "rec.csv")
    with open(filelist, "w") as f:
        f.write("\n".join(rows))
    mel_dir = os.path.join(tmp, "rec_mels")

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        generate_data_statistics.main(["--filelist", filelist, "--wav_dir", wav_dir, "--device", "cuda"])
    stats = dict(line.strip().split(": ") for line in buf.getvalue().splitlines() if ": " in line)
    mean, std = float(stats["mel_mean"]), float(stats["mel_std"])
    check(math.isfinite(mean) and math.isfinite(std) and std > 0, f"statistics {stats}")
    precompute_mels.main(["--filelist", filelist, "--wav_dir", wav_dir, "--mel_dir", mel_dir,
                          "--mel_mean", str(mean), "--mel_std", str(std), "--device", "cuda"])
    prep_s = time.perf_counter() - t0
    check(not os.path.exists(os.path.join(mel_dir, "failures.txt")), "precompute_mels rejected a recording")
    for row in rows:
        rel = row.split("|")[0]
        coarse = np.load(os.path.join(mel_dir, rel + ".npy"))
        fine = np.load(os.path.join(mel_dir, rel + ".fine.npy"))
        for a in (coarse, fine):
            check(a.dtype == np.float32 and a.flags.c_contiguous and a.shape[0] == 100
                  and bool(np.isfinite(a).all()), f"{rel}: cache {a.dtype} {a.shape}")
        check(fine.shape[1] == 2 * coarse.shape[1] - 1, f"{rel}: fine {fine.shape[1]}, coarse {coarse.shape[1]}")

    cfg = bf16_train_config()
    ds = TextMelDataset(filelist, mel_dir)
    tcfg = TrainerConfig(output_dir=os.path.join(tmp, "rec_run"), log_every_n_steps=1,
                         checkpoint_every_n_epochs=100)
    trainer = Trainer(cfg, OptimizerConfig(), tcfg, ds, max_frames_per_batch=32000, len_bucket=32)
    for c in counters.values():
        c.reset()
    try:
        state = trainer.fit(max_steps=1)
    finally:
        trainer.close()
    launches = read_counts(counters)
    with open(os.path.join(tmp, "rec_run", "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
    check(state.step == 1 and losses and all(math.isfinite(x) for x in losses), f"losses {losses}")
    want = step_launches(cfg)
    check(launches == want, f"the step on the port's cache launched {launches}, expected {want}")
    out = {"phase": "corpus_prep", "utterances": len(rows), "mel_mean": mean, "mel_std": std,
           "stats_and_cache_s": prep_s, "train_step_loss": losses[0], "launches": launches}
    emit(out)
    del trainer, state
    torch.cuda.empty_cache()
    return out


def tools_config():
    """The full-width bf16 model of the tools' phases, random weights with
    two changes so that the speaker tables reach the losses: the FiLM
    projection of the duration predictor gets small random weights (it
    starts at identity, which ignores the duration table), and the
    log-duration head small weights around 3.5 fine frames a token (so a
    served request has a speech-like length, as ``production_synthesizer``
    pins it)."""
    from matcha_tpu_torch.models.matcha import init_params

    cfg = bf16_train_config()
    gen = torch.Generator().manual_seed(17)
    params = init_params(cfg, gen)
    w = params["encoder.proj_w.spk_proj.weight"]
    w.copy_(torch.randn(w.shape, generator=gen) * 0.02)
    params["encoder.proj_w.proj.weight"].mul_(0.05)
    params["encoder.proj_w.proj.bias"].fill_(math.log(5.5))
    return cfg, params


def phase_finetune_speaker(tmp: str, counters) -> dict:
    """A full-width random checkpoint (``save_checkpoint``), then
    ``finetune_speaker.finetune`` for 3 steps of B=62 x 512 with every row
    given the target speaker; every parameter but the two tables, and every
    other row, must come back bitwise equal, and the target rows must move.
    Then one masked step profiled."""
    import numpy as np

    from matcha_tpu_torch.checkpoint import load_checkpoint
    from matcha_tpu_torch.finetune_speaker import finetune, trainable_mask_for_speaker
    from matcha_tpu_torch.train.checkpoint import save_checkpoint
    from matcha_tpu_torch.train.optim import AdamW, OptimizerConfig
    from matcha_tpu_torch.train.step import TrainStep
    from matcha_tpu_torch.weights import decay_mask, flatten_tree

    cfg, params = tools_config()
    ckpt = os.path.join(tmp, "tools_ckpt")
    save_checkpoint(ckpt, params, AdamW(OptimizerConfig(), decay_mask(cfg)).init(params), 0, 0, cfg)
    with open(os.path.join(tmp, "train.csv")) as f:
        rows = f.read().splitlines()[:62]  # the 512 bucket: one B=62 batch an epoch
    filelist = os.path.join(tmp, "target.csv")
    with open(filelist, "w") as f:
        f.write("\n".join("|".join([r.split("|")[0], str(FINETUNE_SPEAKER), *r.split("|")[2:]]) for r in rows))
    out_dir = os.path.join(tmp, "finetune_run")
    conf = {"model": cfg.to_dict(), "ckpt_path": ckpt, "device": "cuda", "seed": 1234,
            "data": {"train_filelist_path": filelist, "mel_dir": os.path.join(tmp, "mels"),
                     "max_frames_per_batch": 32000, "len_bucket": 32},
            "trainer": {"max_epochs": 3, "checkpoint_every_n_epochs": 100, "log_every_n_steps": 1},
            "paths": {"output_dir": out_dir}}
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = finetune(conf, FINETUNE_SPEAKER)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts(counters)
    check(state.step == 3, f"the fine-tune ran {state.step} steps, expected 3")
    per_step = step_launches(cfg)
    check(launches == {n: 3 * k for n, k in per_step.items()},
          f"the fine-tune launched {launches} in 3 steps, expected {per_step} a step")

    before = flatten_tree(load_checkpoint(ckpt)[0]["params"])
    after = flatten_tree(load_checkpoint(sorted(glob.glob(os.path.join(out_dir, "checkpoints", "epoch_*")))[-1])[0]
                         ["params"])
    others = [i for i in range(cfg.n_spks) if i != FINETUNE_SPEAKER]
    moved = {}
    for k, v in before.items():
        if k.startswith("speaker_embeddings"):
            check(np.array_equal(after[k][others], v[others]), f"{k}: a non-target row changed")
            moved[k] = float(np.abs(after[k][FINETUNE_SPEAKER] - v[FINETUNE_SPEAKER]).max())
            check(moved[k] > 0, f"{k}: the target row did not move")
        else:
            check(np.array_equal(after[k], v), f"{k} changed in a fine-tune")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses), f"fine-tune losses {losses}")

    ts = TrainStep(cfg, OptimizerConfig(), device="cuda", trainable=trainable_mask_for_speaker(cfg))
    pstate = ts.init_state(params)
    batch = fixed_batch(tmp, cfg, 62)
    batch = batch._replace(spks=torch.full_like(batch.spks, FINETUNE_SPEAKER))
    ts.train_step(pstate, batch, 0)  # warm-up
    profile = device_breakdown(lambda: ts.train_step(pstate, batch, 0),
                               kernels=("masked_attention_fwd", "attn_bwd_dq", "attn_bwd_dkv", "mas_kernel"))
    out = {"phase": "finetune_speaker", "steps": state.step, "batch": [62, 512], "wall_s_3_steps": wall_s,
           "losses": losses, "launches": launches, "frozen_params_bitwise_equal": len(before) - 2,
           "target_row_max_change": moved, "step_profile": profile}
    emit(out)
    del ts, pstate, state
    torch.cuda.empty_cache()
    return out


def style_gradients(tmp: str, backend: str, dtype, betas: dict) -> dict:
    """The StyleEncoder loss and its gradients on a B=2 batch of the
    synthetic corpus, ``tools_config`` weights, the frozen encoder and
    the StyleEncoder in ``dtype`` (float32, or float64 for the reference
    run: the encoder's fp32 islands and norm statistics in float64 too)
    with attention ``backend``; one (loss, parts, grads) per entry of
    ``betas``."""
    import dataclasses

    from matcha_tpu_torch.models.matcha import MatchaTTS
    from matcha_tpu_torch.models.style_encoder import StyleEncoder, init_style_params, style_encoder_loss
    from matcha_tpu_torch.models.text_encoder import TextEncoder
    from matcha_tpu_torch.text.symbols import N_VOCAB

    base, params = tools_config()
    cfg = dataclasses.replace(base, compute_dtype="float32", attention_backend=backend)
    model = MatchaTTS(cfg)
    model.load_state_dict(params)
    if dtype == torch.float64:
        encoder = TextEncoder(cfg.encoder, cfg.duration_predictor, N_VOCAB, cfg.spk_emb_dim,
                              dtype=dtype, attn_backend=backend)
        encoder.load_state_dict(model.encoder.state_dict())
        model.encoder = encoder
    model.cuda().eval().requires_grad_(False)
    style = StyleEncoder(cfg.n_feats, cfg.spk_emb_dim, dtype=dtype)
    style.load_state_dict(init_style_params(base, torch.Generator().manual_seed(4)))
    style.cuda()
    batch = fixed_batch(tmp, base, 2)
    # the inputs of every ReLU the StyleEncoder's gradient passes through:
    # its own convs, and the predicted branch's (grad-enabled) encoder FFNs
    # and duration-predictor convs
    relu_inputs = []
    convs = [getattr(style, f"conv{i}") for i in range(style.n_layers)]
    convs += [f.conv_1 for f in model.encoder.encoder.ffn_layers] + list(model.encoder.proj_w.conv_layers)
    hooks = [c.register_forward_hook(
        lambda m, a, out: relu_inputs.append(out.detach() > 0) if torch.is_grad_enabled() else None) for c in convs]
    names = [n for n, _ in style.named_parameters()]
    runs = {}
    for which, kw in betas.items():
        loss, parts = style_encoder_loss(style, model, batch, **kw)
        grads = torch.autograd.grad(loss, [p for _, p in style.named_parameters()])
        runs[which] = (loss.item(), {k: float(v) for k, v in parts.items()},
                       {n: g.double() for n, g in zip(names, grads)})
    for h in hooks:
        h.remove()
    runs["relu_on"] = relu_inputs[:len(convs)]  # the forward is the same for every betas entry
    return runs


def style_reference(tmp: str) -> dict:
    """The kernel path's StyleEncoder loss and gradients (fp32) against the
    plain path's (fp32, einsum attention), and both against the plain path
    in float64, at beta 1 and at the tool's betas (0.002 / 0.004).  Each
    gradient error is max |err| / max |ref| per parameter, the worst
    parameter reported.  ``relu_flips`` counts the ReLU units whose input
    lies on the other side of 0 than in the other run: fp32 rounding can
    carry an input within ~1e-7 of 0 across it, which switches that
    unit's gradient on or off, a step change that no tolerance on
    rounding covers."""
    betas = {"tool": {}, "unit": {"acoustic_beta": 1.0, "rhythm_beta": 1.0}}
    runs = {name: style_gradients(tmp, backend, dtype, betas)
            for name, backend, dtype in (("kernel", "auto", torch.float32), ("plain", "einsum", torch.float32),
                                         ("float64", "einsum", torch.float64))}

    def errors(got, ref):
        return {n: ((got[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30)).item() for n in ref}

    def worst(got, ref):
        errs = errors(got, ref)
        name = max(errs, key=errs.get)
        return {"rel_err": errs[name], "param": name}

    def flips(a, b):
        return sum(int((x != y).sum()) for x, y in zip(runs[a]["relu_on"], runs[b]["relu_on"]))

    out = {"relu_flips": {"kernel_vs_plain": flips("kernel", "plain"), "kernel_vs_float64": flips("kernel", "float64"),
                          "plain_vs_float64": flips("plain", "float64")}}
    for which in betas:
        (lk, pk, gk), (lp, pp, gp), (l64, _, g64) = (runs[n][which] for n in ("kernel", "plain", "float64"))
        out[which] = {"loss_kernel": lk, "loss_plain": lp, "loss_float64": l64, "parts_kernel": pk,
                      "parts_plain": pp, "loss_rel_err": abs(lk - lp) / abs(lp),
                      "loss_kernel_vs_float64": abs(lk - l64) / abs(l64),
                      "grad_kernel_vs_plain": worst(gk, gp), "grad_kernel_vs_float64": worst(gk, g64),
                      "grad_plain_vs_float64": worst(gp, g64),
                      "grad_by_param": {"kernel_vs_plain": errors(gk, gp), "kernel_vs_float64": errors(gk, g64),
                                        "plain_vs_float64": errors(gp, g64)}}
    return out


def phase_style_encoder(tmp: str, counters) -> dict:
    """``train_style_encoder.train`` for 20 steps on one B=62 x 512 batch
    against the frozen checkpoint; then, in fp32 on a small batch, the
    kernel path's loss and StyleEncoder gradients against the plain path
    and both against float64 (``style_reference``); then one step
    profiled."""
    from matcha_tpu_torch.models.style_encoder import StyleEncoder
    from matcha_tpu_torch.train_style_encoder import (
        load_frozen_model,
        style_optimizer,
        style_train_step,
        train,
    )

    ckpt = os.path.join(tmp, "tools_ckpt")
    out_dir = os.path.join(tmp, "style_run")
    conf = {"ckpt_path": ckpt, "seed": 1234, "paths": {"output_dir": out_dir},
            "data": {"train_filelist_path": os.path.join(tmp, "short.csv"), "mel_dir": os.path.join(tmp, "mels"),
                     "max_frames_per_batch": 32000, "len_bucket": 32}}
    with open(os.path.join(tmp, "train.csv")) as f:
        rows = f.read().splitlines()[:62]
    with open(conf["data"]["train_filelist_path"], "w") as f:
        f.write("\n".join(rows))
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train(conf, max_epochs=20, lr=1e-3, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts(counters)
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        losses = [json.loads(line)["loss"] for line in f]
    drop = 1.0 - losses[-1] / losses[0]
    check(len(losses) == 20 and all(math.isfinite(x) for x in losses), f"style losses {losses}")
    check(drop >= 0.05, f"the style loss fell {drop:.3f} in 20 steps, less than 5 %")
    per_step = {"masked_attention_fwd": 8, "masked_attention_bwd": 4, "mas": 0}
    check(launches == {n: 20 * k for n, k in per_step.items()},
          f"20 style steps launched {launches}, expected {per_step} a step")

    # kernel path against plain path as phase_train_reference (loss 1e-4,
    # gradients 1e-3); at the tool's betas the gradients are held to 1e-3
    # unless a ReLU unit is on in one path and off in the other (see
    # style_reference), and then to 1e-2, the single switched unit of the
    # measured run giving 1.4e-3 (PERF.md)
    reference = style_reference(tmp)
    switched = reference["relu_flips"]["kernel_vs_plain"] > 0
    reference["tol"] = {"loss": 1e-4, "loss_vs_float64": 1e-5, "grad_unit_beta": 1e-3,
                        "grad_tool_betas": 1e-2 if switched else 1e-3}
    for which in ("unit", "tool"):
        r = reference[which]
        check(r["loss_rel_err"] <= 1e-4 and r["loss_kernel_vs_float64"] <= 1e-5,
              f"style loss ({which} betas): {r}")
    check(reference["unit"]["grad_kernel_vs_plain"]["rel_err"] <= 1e-3,
          f"style gradients at beta 1: {reference['unit']}")
    check(reference["tool"]["grad_kernel_vs_plain"]["rel_err"] <= reference["tol"]["grad_tool_betas"],
          f"style gradients at the tool's betas: {reference['tool']}, ReLU flips {reference['relu_flips']}")

    model = load_frozen_model(ckpt, "cuda")
    style = StyleEncoder(model.cfg.n_feats, model.cfg.spk_emb_dim).cuda()
    opt = style_optimizer(style, 1e-3)
    opt_state = opt.init(dict(style.named_parameters()))
    big = fixed_batch(tmp, model.cfg, 62)
    style_train_step(style, model, opt, opt_state, big)  # warm-up
    profile = device_breakdown(lambda: style_train_step(style, model, opt, opt_state, big),
                               kernels=("masked_attention_fwd", "attn_bwd_dq", "attn_bwd_dkv", "mas_kernel"))
    prof_launches = {k: v["launches"] for k, v in profile["kernels"].items()}
    # each K1b call is three device launches: the fused pass (attn_bwd_dkv_dq_*)
    # between the delta pre-pass and the dq post-pass (attn_bwd_dq_*)
    check(prof_launches == {"masked_attention_fwd": 8, "attn_bwd_dq": 8, "attn_bwd_dkv": 4, "mas_kernel": 0},
          f"the profiled style step launched {prof_launches}")
    out = {"phase": "style_encoder", "steps": len(losses), "batch": [62, 512], "lr": 1e-3,
           "losses": losses, "relative_drop": drop, "required_drop": 0.05, "wall_s_20_steps": wall_s,
           "launches": launches, "launches_per_step": per_step,
           "reference": reference,
           "step_profile": profile}
    emit(out)
    del model, style
    torch.cuda.empty_cache()
    return out


def phase_add_speaker(tmp: str, counters) -> dict:
    """A Vocos pickle (``vocos_params_to_jax``), ``add_speaker`` on the ten
    recordings (n_spks 16 → 17), the new speaker served at B=1 fused."""
    import pickle

    from matcha_tpu_torch import add_speaker
    from matcha_tpu_torch.checkpoint import load_checkpoint, load_synthesizer
    from matcha_tpu_torch.vocoder.vocos import VocosConfig, init_vocos_params
    from matcha_tpu_torch.weights import vocos_params_to_jax

    vcfg = VocosConfig()
    vocos_pkl = os.path.join(tmp, "vocos.pkl")
    with open(vocos_pkl, "wb") as f:
        pickle.dump(vocos_params_to_jax(init_vocos_params(vcfg, torch.Generator().manual_seed(8)), vcfg), f)
    out_ckpt = os.path.join(tmp, "added_ckpt")
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    add_speaker.main(["--checkpoint_path", os.path.join(tmp, "tools_ckpt"),
                      "--style_params", os.path.join(tmp, "style_run", "style_params.pkl"),
                      "--wav_dir", os.path.join(ROOT, "mcd_validation"), "--output", out_ckpt,
                      "--device", "cuda"])
    add_s = time.perf_counter() - t0
    tree, cfg = load_checkpoint(out_ckpt)
    table = tree["params"]["speaker_embeddings_enc"]["embedding"]
    check(cfg.n_spks == NEW_SPEAKER + 1 and table.shape[0] == NEW_SPEAKER + 1, f"n_spks {cfg.n_spks}")
    synth = load_synthesizer(out_ckpt, vocos_pkl, device="cuda")
    ids = ids_of(200, 31)
    synth.synthesise_ids(ids, speaker=NEW_SPEAKER, scale_correction=1.0, fused=True)
    r = synth.synthesise_ids(ids, speaker=NEW_SPEAKER, scale_correction=1.0, fused=True)
    check_wav(r.wav, len(ids), "new speaker, B=1 fused")
    launches = read_counts(counters)
    want = {"masked_attention_fwd": 2 * request_launches(cfg), "masked_attention_bwd": 0, "mas": 0}
    check(launches == want, f"add_speaker and two requests of the new speaker launched {launches}, expected {want}")
    out = {"phase": "add_speaker", "n_spks": cfg.n_spks, "recordings": 10, "add_speaker_wall_s": add_s,
           "served_samples": len(r.wav), "served_latency_ms": r.latency_s * 1e3, "launches": launches}
    emit(out)
    del synth
    torch.cuda.empty_cache()
    return out


def phase_cli_mcd(tmp: str, counters) -> dict:
    """``cli.main`` for speakers 0 and 16; ``compute_mcd`` over the
    recordings against a gain-and-noise copy of each (mel basis on the card,
    sptk basis); ``vocoder.selftest`` and ``mcd_validate`` on two
    recordings.  The weights are random: the MCDs say the tools run and
    give finite numbers, not how good anything sounds."""
    import contextlib
    import shutil

    import numpy as np

    from matcha_tpu_torch import cli
    from matcha_tpu_torch.utils import compute_mcd, mcd_validate
    from matcha_tpu_torch.utils.audio_io import read_wav, write_wav
    from matcha_tpu_torch.vocoder import selftest

    ckpt, vocos_pkl = os.path.join(tmp, "added_ckpt"), os.path.join(tmp, "vocos.pkl")
    ids = ",".join(str(i) for i in ids_of(120, 41))
    cli_dir = os.path.join(tmp, "cli_out")
    for c in counters.values():
        c.reset()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["--phoneme_ids", ids, "--checkpoint_path", ckpt, "--vocoder_path", vocos_pkl,
                  "--spk", f"0,{NEW_SPEAKER}", "--output_dir", cli_dir, "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    launches = read_counts(counters)
    want = {"masked_attention_fwd": 2 * request_launches(bf16_train_config()), "masked_attention_bwd": 0,
            "mas": 0}
    check(launches == want, f"the CLI's two speakers launched {launches}, expected {want}")
    rtf_lines = [line for line in buf.getvalue().splitlines() if line.startswith("[+]") and "RTF=" in line]
    check(len(rtf_lines) == 2, f"CLI printed {buf.getvalue()!r}")
    for spk in (0, NEW_SPEAKER):
        wav, sr = read_wav(os.path.join(cli_dir, f"speaker_{spk:03d}.wav"))
        check(sr == 24000 and len(wav) > 0 and bool(np.isfinite(wav).all()), f"CLI wav of speaker {spk}")

    gen_dir = os.path.join(tmp, "generated")
    os.makedirs(gen_dir)
    rng = np.random.default_rng(9)
    for path in recordings():
        wav, sr = read_wav(path)
        noisy = 0.8 * wav + 0.003 * rng.standard_normal(len(wav))
        write_wav(os.path.join(gen_dir, os.path.basename(path).replace("original_", "generated_")), noisy, sr)
    two = os.path.join(tmp, "two_wavs")
    os.makedirs(os.path.join(two, "rec"))
    rows = []
    for i, path in enumerate(recordings()[:2]):
        shutil.copy(path, os.path.join(two, "rec", os.path.basename(path)))
        rows.append(f"rec/{os.path.basename(path)[:-4]}|{(0, NEW_SPEAKER)[i]}|en-us|t|{ids.replace(',', ' ')}")
    filelist = os.path.join(tmp, "validate.csv")
    with open(filelist, "w") as f:
        f.write("\n".join(rows))
    scores = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        for basis in ("mel", "sptk"):
            scores[f"compute_mcd_{basis}"] = compute_mcd.main(
                ["--dir", os.path.join(ROOT, "mcd_validation"), "--generated_dir", gen_dir,
                 "--mcd_basis", basis, "--device", "cuda"])
        scores["vocoder_selftest"] = selftest.main(["--vocoder_path", vocos_pkl, "--wav_dir", os.path.join(two, "rec"),
                                                    "--device", "cuda"])
        scores["mcd_validate"] = mcd_validate.main(["--checkpoint_path", ckpt, "--vocoder_path", vocos_pkl,
                                                    "--filelist", filelist, "--wav_dir", two,
                                                    "--samples_per_speaker", "1", "--device", "cuda"])
    mcd_s = time.perf_counter() - t0
    counts = {"compute_mcd_mel": 10, "compute_mcd_sptk": 10, "vocoder_selftest": 2, "mcd_validate": 2}
    for k, v in scores.items():
        check(len(v) == counts[k] and all(math.isfinite(x) for x in v), f"{k}: MCDs {v}")
    out = {"phase": "cli_mcd", "cli_wall_s": cli_s, "cli_lines": rtf_lines, "mcd_tools_wall_s": mcd_s,
           "mcd_db": scores, "mcd_note": "random weights: tool checks, not quality", "launches": launches}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# seeded noise, checkpoints across frameworks, data-parallel training and the
# serving fan-out
# ---------------------------------------------------------------------------

# the JAX package's seeded row at seed 42, (2048, 100): first four values and
# float64 sum (tests/test_torch_seeded_noise.py pins them from JAX)
JAX_ROW42_HEAD = (-0.02830461598932743, 0.4671318531036377, 0.2957029640674591, 0.15354591608047485)
JAX_ROW42_SUM = -605.9497001221935
PINNED_KEYS = os.path.join(ROOT, "tests", "fixtures", "jax_trainer_opt_state_keys.json")
DP_OPT = {"eps": 1e-3}  # Adam eps of the parity runs, as the CPU tests hold one step


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def phase_seeded_noise(synth) -> dict:
    """Seeded synthesis: the same request twice gives the same audio; the
    noise row of a bucket is the first rows of the largest bucket's; the
    seed-42 row against the JAX package's values."""
    import numpy as np

    from matcha_tpu_torch.models.flow_matching import seeded_synthesis_noise

    ids = ids_of(200, 1)
    a = synth.synthesise_ids(ids, scale_correction=1.0, fused=True)
    b = synth.synthesise_ids(ids, scale_correction=1.0, fused=True)
    check(a.wav.shape == b.wav.shape and np.array_equal(a.wav, b.wav), "two equal requests gave other audio")
    rep = synth.replicas[0]
    check(torch.equal(rep.noise(1, 512)[0], rep.noise_row[:512]), "bucket 512's noise is not a prefix")
    check(torch.equal(rep.noise_row[:512].cpu(), seeded_synthesis_noise(512, synth.cfg.n_feats)),
          "the largest bucket's row does not start with the 512 row")
    row = seeded_synthesis_noise(2048, 100, 42).numpy()
    head, total = row[0, :4].tolist(), float(row.astype(np.float64).sum())
    head_err = max(abs(x - y) for x, y in zip(head, JAX_ROW42_HEAD))
    out = {"phase": "seeded_noise", "samples": len(a.wav), "audio_equal": True,
           "row42_head": head, "row42_sum_fp64": total, "jax_row42_head": list(JAX_ROW42_HEAD),
           "jax_row42_sum_fp64": JAX_ROW42_SUM, "head_max_abs_err": head_err,
           "sum_abs_err": abs(total - JAX_ROW42_SUM)}
    emit(out)
    check(head_err <= 1e-6 and abs(total - JAX_ROW42_SUM) <= 1e-3, "the seed-42 row is not the JAX package's")
    return out


def phase_checkpoint_crossing(tmp: str, dev: str = "cuda") -> dict:
    """A Trainer's checkpoint after one step holds the JAX trainer's key
    paths (the list tests/test_torch_checkpoint_crossing.py pins); reloaded,
    it takes the next step as the uninterrupted state does."""
    import numpy as np

    from matcha_tpu_torch.data.dataset import TextMelDataset
    from matcha_tpu_torch.train.optim import OptimizerConfig
    from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = bf16_train_config()
    tcfg = TrainerConfig(output_dir=os.path.join(tmp, "crossing"), seed=1234, use_mesh=False)
    trainer = Trainer(cfg, OptimizerConfig(**DP_OPT), tcfg,
                      TextMelDataset(os.path.join(tmp, "train.csv"), os.path.join(tmp, "mels")), device=dev)
    try:
        batches = [fixed_batch(tmp, cfg, 62, dev), fixed_batch(tmp, cfg, 62, dev, offset=1)]
        state = trainer.init_state()
        state, _ = trainer.train_step(state, batches[0], 1234)
        trainer.save(state, 0)
        path = os.path.join(tmp, "crossing", "checkpoints", "epoch_00000")
        with np.load(os.path.join(path, "state.npz")) as data:
            opt_keys = sorted(k for k in data.files if k.startswith("['opt_state']"))
        with open(PINNED_KEYS) as f:
            pinned = json.load(f)["keys"]
        resumed = trainer.init_state(resume_from=path)
        same = (resumed.step == state.step and int(resumed.opt_state.count) == int(state.opt_state.count)
                and all(torch.equal(resumed.params[n], state.params[n]) for n in state.params)
                and all(torch.equal(getattr(resumed.opt_state, f)[n], getattr(state.opt_state, f)[n])
                        for f in ("mu", "nu") for n in state.params))
        state, m_run = trainer.train_step(state, batches[1], 1234)
        resumed, m_res = trainer.train_step(resumed, batches[1], 1234)
        loss_err = abs(float(m_res["loss"]) - float(m_run["loss"])) / abs(float(m_run["loss"]))
        param_err = max(float((resumed.params[n] - state.params[n]).detach().abs().max()) for n in state.params)
    finally:
        trainer.close()
    out = {"phase": "checkpoint_crossing", "opt_state_keys": len(opt_keys), "pinned_keys": len(pinned),
           "keys_equal_pinned": opt_keys == pinned, "reloaded_bit_equal": same,
           "next_step_loss_rel_err": loss_err, "loss_tol": 1e-5,
           "next_step_param_max_abs_err": param_err, "param_tol": 1e-5}
    emit(out)
    check(opt_keys == pinned, f"{len(set(opt_keys) ^ set(pinned))} opt_state keys differ from the JAX trainer's")
    check(same, "the reloaded state is not the saved one")
    check(loss_err <= 1e-5 and param_err <= 1e-5, "the resumed step differs from the uninterrupted one")
    return out


def short_corpus(tmp: str) -> str:
    """The training corpus's 62 utterances of bucket 512 (B=62): one batch
    an epoch, which splits 31 + 31 over two ranks."""
    with open(os.path.join(tmp, "train.csv")) as f:
        rows = f.read().splitlines()[:62]
    path = os.path.join(tmp, "short.csv")
    with open(path, "w") as f:
        f.write("\n".join(rows))
    return path


def no_dropout(cfg):
    import dataclasses

    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, p_dropout=0.0),
        duration_predictor=dataclasses.replace(cfg.duration_predictor, p_dropout=0.0),
        decoder=dataclasses.replace(cfg.decoder, dropout=0.0))


def dp_run(tmp: str, filelist: str, name: str, cfg, dev, use_mesh: bool, steps: int = 3,
           tensor_parallel: int = 1) -> dict:
    """A Trainer over ``filelist`` for ``steps`` steps (data-parallel when a
    process group runs and ``use_mesh``; tensor-parallel over ``tensor_parallel``
    ranks): per-step losses, wall times and launches, peak memory, launch
    signatures, the final parameters on the host (whole tensors, gathered
    over the tensor-parallel group)."""
    from matcha_tpu_torch.data.dataset import TextMelDataset
    from matcha_tpu_torch.train.optim import OptimizerConfig
    from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig

    counters = train_counters()
    tcfg = TrainerConfig(output_dir=os.path.join(tmp, name), max_epochs=steps, log_every_n_steps=1,
                         checkpoint_every_n_epochs=100, seed=1234, use_mesh=use_mesh,
                         tensor_parallel=tensor_parallel)
    trainer = Trainer(cfg, OptimizerConfig(**DP_OPT), tcfg,
                      TextMelDataset(filelist, os.path.join(tmp, "mels")),
                      max_frames_per_batch=32000, len_bucket=32, device=dev)
    steps_out = []
    real_step = trainer.train_step

    def timed_step(state, batch, seed):
        sync(dev)
        before = {n: c.launches for n, c in counters.items()}
        t0 = time.perf_counter()
        state, metrics = real_step(state, batch, seed)
        sync(dev)
        steps_out.append({"seconds": time.perf_counter() - t0, "rows": batch.y.shape[0],
                          "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                          "launches": {n: c.launches - before[n] for n, c in counters.items()}})
        return state, metrics

    trainer.train_step = timed_step
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.reset()
    try:
        state = trainer.fit(max_steps=steps)
        world, rank = trainer.world, trainer.rank
        peak = torch.cuda.max_memory_allocated() / 2**30 if torch.device(dev).type == "cuda" else None
        launches = {n: c.launches for n, c in counters.items()}
        local_mib = sum(p.numel() * 4 for p in state.params.values()) / 2**20
        whole, _ = trainer.steps.whole_state(state)
    finally:
        trainer.close()
    return {"world": world, "rank": rank, "steps": steps_out, "peak_memory_gib": peak,
            "launches": launches, "signatures": {n: c.signatures for n, c in counters.items()},
            "param_mib_on_rank": local_mib, "out_dir": tcfg.output_dir,
            "params": {n: p.detach().cpu() for n, p in whole.items()}}


def dp_worker(rank: int, world: int, store: str, tmp: str, filelist: str, cfg, dev: str) -> None:
    """One rank of the two-rank run: gloo, both ranks on the same card."""
    sys.path.insert(0, ROOT)
    from matcha_tpu_torch.parallel import mesh

    mesh.init_data_parallel(dev, backend="gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        res = dp_run(tmp, filelist, "dp_w2", cfg, dev, use_mesh=True)
    finally:
        mesh.destroy()
    torch.save(res, os.path.join(tmp, f"dp_rank{rank}.pt"))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def max_param_diff(a: dict, b: dict) -> float:
    return max(float((a[n].float() - b[n].float()).abs().max()) for n in a)


def phase_dp_train(tmp: str, dev: str = "cuda") -> dict:
    """Data-parallel training through the Trainer: world 1 over NCCL against
    one process; at dropout 0, world 2 over gloo (both ranks on this card,
    31 + 31 rows) against world 1."""
    import torch.multiprocessing as mp

    from matcha_tpu_torch.parallel import mesh

    cfg = bf16_train_config()
    filelist = short_corpus(tmp)
    single = dp_run(tmp, filelist, "dp_single", cfg, dev, use_mesh=False)
    mesh.init_data_parallel(dev, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        check(mesh.world() == 1 and (torch.device(dev).type != "cuda" or
                                     torch.distributed.get_backend() == "nccl"), "world 1 is not NCCL")
        w1 = dp_run(tmp, filelist, "dp_w1", cfg, dev, use_mesh=True)
        w1_nodrop = dp_run(tmp, filelist, "dp_w1_nodrop", no_dropout(cfg), dev, use_mesh=True)
    finally:
        mesh.destroy()
    store = os.path.join(tmp, "dp_store")
    t0 = time.perf_counter()
    mp.start_processes(dp_worker, args=(2, store, tmp, filelist, no_dropout(cfg), dev), nprocs=2, join=True,
                       start_method="spawn")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"dp_rank{r}.pt")) for r in range(2)]
    for run in (w1, w1_nodrop, *ranks):  # every run's launch signatures join the path checks
        for n, sigs in run["signatures"].items():
            LAUNCHED.setdefault(n, set()).update(sigs)

    def compare(run, ref) -> dict:
        pairs = [(s["loss"], r["loss"]) for s, r in zip(run["steps"], ref["steps"])]
        return {"first_loss_rel_err": abs(pairs[0][0] - pairs[0][1]) / abs(pairs[0][1]),
                "loss_rel_err": max(abs(x - y) / abs(y) for x, y in pairs),
                "param_max_abs_err": max_param_diff(run["params"], ref["params"])}

    w1_vs_single = compare(w1, single)
    w2_vs_w1 = compare(ranks[0], w1_nodrop)
    ranks_equal = all(torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]) for n in ranks[0]["params"])

    def summary(run):
        return {"world": run["world"], "rank": run["rank"], "rows_per_step": [s["rows"] for s in run["steps"]],
                "losses": [s["loss"] for s in run["steps"]], "step_s": [s["seconds"] for s in run["steps"]],
                "peak_memory_gib": run["peak_memory_gib"], "launches": run["launches"],
                "launches_per_step": run["steps"][-1]["launches"]}

    out = {"phase": "dp_train", "compute_dtype": cfg.compute_dtype, "adam_eps": DP_OPT["eps"],
           "single": summary(single), "world1_nccl": summary(w1), "world1_nccl_dropout0": summary(w1_nodrop),
           "world2_gloo_dropout0": [summary(r) for r in ranks], "world2_spawn_s": spawn_s,
           "world1_vs_single": w1_vs_single, "world2_vs_world1": w2_vs_w1,
           "world2_ranks_bit_identical": ranks_equal, "first_loss_tol": 1e-5, "loss_tol": 1e-2,
           "param_tol": 1e-5}
    emit(out)
    for run, run_cfg in ((w1, cfg), (w1_nodrop, no_dropout(cfg)), *((r, no_dropout(cfg)) for r in ranks)):
        want = step_launches(run_cfg)
        check(all(s["launches"] == want for s in run["steps"]), f"a DP step launched other than {want}")
    check([s["rows"] for s in ranks[0]["steps"]] == [31] * 3, "world 2 did not split 62 rows 31 + 31")
    check(ranks_equal, "the two ranks' parameters differ")
    # the first step starts from equal weights; later ones carry the card's
    # run-to-run noise: the backward's atomic sums move parameters by ~1e-6,
    # enough to move a weight across a bf16 rounding step, so their losses
    # are held to 1e-2 (up to 6.6e-4 on an H100) and the parameters to 1e-5
    for name, err in (("world 1 vs one process", w1_vs_single), ("world 2 vs world 1", w2_vs_w1)):
        check(err["first_loss_rel_err"] <= 1e-5 and err["loss_rel_err"] <= 1e-2
              and err["param_max_abs_err"] <= 1e-5, f"{name}: {err}")
    out["launches"] = w1["launches"]
    return out


def phase_fanout(synth, counters, dev: str = "cuda") -> dict:
    """The serving fan-out over two replicas on this card against the
    single-device synthesizer: a B=16 fused batch (8 rows a replica), a
    3-request batch (padded to 4: 2 rows a replica, one of them a 1-token
    pad row) and one request (padded to one row a replica).  Each replica's
    rows must equal, bit for bit, the single synthesizer's on the same block
    of rows; against the single synthesizer's whole-batch call they differ
    by bf16 rounding, which depends on the batch's shape (printed, with the
    same difference between two single-synthesizer calls of 16 and 8 rows).

    The single synthesizer's calls all run first; the counts are set to 0
    just before the fan-out's calls and read just after them, and every
    call must launch K1 ``request_launches`` times on each replica."""
    import numpy as np

    fan = production_synthesizer("bfloat16", mesh=[dev, dev])
    lists = [ids_of(180 + 4 * i, 100 + i) for i in range(16)]
    mixes = [[(15, 1.0)]] * 16  # voice 15 carries no scale correction, as a pad row
    three, ids = lists[:3], ids_of(200, 1)

    def err(a, b):
        check(len(a) == len(b) and all(x.wav.shape == y.wav.shape for x, y in zip(a, b)), "row shapes differ")
        return max(float(np.abs(x.wav - y.wav).max()) for x, y in zip(a, b))

    def timed_b16(s, into):
        sync(dev)
        t0 = time.perf_counter()
        out = s.synthesise_batch(lists, voice_mixes=mixes, fused=True)
        into.append(time.perf_counter() - t0)
        return out

    # the single synthesizer: the references, off the counts
    times = {"single_b16_s": [], "fanout_b16_s": []}
    synth.synthesise_batch(lists, voice_mixes=mixes, fused=True)  # first B=16 call
    for _ in range(3):
        single_b16 = timed_b16(synth, times["single_b16_s"])
    halves = (synth.synthesise_batch(lists[:8], voice_mixes=mixes[:8], fused=True)
              + synth.synthesise_batch(lists[8:], voice_mixes=mixes[8:], fused=True))
    blocks_b3 = (synth.synthesise_batch(three[:2], voice_mixes=mixes[:2], fused=True)
                 + synth.synthesise_batch([three[2], [0]], voice_mixes=mixes[:2], fused=True)[:1])
    single_b3 = synth.synthesise_batch(three, voice_mixes=mixes[:3], fused=True)
    single_b1 = synth.synthesise_ids(ids, scale_correction=1.0, fused=True)

    # the fan-out path alone between the reset and the read
    for c in counters.values():
        c.reset()
    fan.synthesise_batch(lists, voice_mixes=mixes, fused=True)  # first call: allocator, cuDNN
    for _ in range(3):
        fan_b16 = timed_b16(fan, times["fanout_b16_s"])
    fan_b3 = fan.synthesise_batch(three, voice_mixes=mixes[:3], fused=True)
    fan_b1 = fan.synthesise_ids(ids, scale_correction=1.0, fused=True)
    launches = read_counts(counters)
    calls = 6
    want = {n: 0 for n in launches}
    want["masked_attention_fwd"] = calls * len(fan.replicas) * request_launches(fan.cfg)

    per_block = {"b16_fused": err(fan_b16, halves), "b3_padded": err(fan_b3, blocks_b3),
                 "b1_request": err([fan_b1], [single_b1])}
    whole_batch = {"b16_fused": err(fan_b16, single_b16), "b3_padded": err(fan_b3, single_b3),
                   "single_b16_vs_single_halves": err(single_b16, halves)}
    out = {"phase": "fanout", "devices": [str(d) for d in fan.mesh],
           "max_abs_err_vs_single_on_each_block": per_block, "tol": 0.0,
           "max_abs_err_vs_single_whole_batch_bf16": whole_batch,
           "b16_fused_s_median": {k: statistics.median(v) for k, v in times.items()}, "b16_fused_s": times,
           "calls": calls, "launches": launches, "expected_launches": want,
           "k1_launches_per_replica_per_call": request_launches(fan.cfg)}
    emit(out)
    check(launches == want, f"the fan-out launched {launches}, expected {want}")
    check(max(per_block.values()) == 0.0, f"fan-out rows differ from the single synthesizer's: {per_block}")
    del fan
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# tensor parallelism, the decoder's switches (Conformer, remat, bf16 norm
# statistics) and the segment DP
# ---------------------------------------------------------------------------

def v20_train_config(dropout: bool = True):
    """configs/experiment/v20-production.yaml's model section over bf16.yaml,
    built from the dataclasses (the card's machine may lack PyYAML):
    decoder 384 = 6 x 64, encoder 6 x 48 heads."""
    import dataclasses

    from matcha_tpu_torch.models.config import MatchaConfig

    base = MatchaConfig()
    cfg = dataclasses.replace(
        base, compute_dtype="bfloat16", spk_emb_dim=96, prior_loss=True, prior_loss_threshold=0.15,
        duration_loss_threshold=0.3,
        encoder=dataclasses.replace(base.encoder, n_channels=192, filter_channels=1152, n_heads=6, n_layers=4,
                                    kernel_size=5, p_dropout=0.05, prenet_kernel_size=3),
        duration_predictor=dataclasses.replace(base.duration_predictor, filter_channels=96, kernel_size=5,
                                               n_layers=4, p_dropout=0.05),
        decoder=dataclasses.replace(base.decoder, channels=(384, 384), attention_head_dim=64, num_heads=6,
                                    dropout=0.05))
    return cfg if dropout else no_dropout(cfg)


def param_diff(a: dict, b: dict) -> tuple[float, str]:
    """max |a − b| over all parameters, and where."""
    errs = {n: float((a[n].float() - b[n].float()).abs().max()) for n in a}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def tp_worker(rank: int, store: str, tmp: str, filelist: str, runs, dev: str) -> None:
    """One rank of the dp 1 x tp 2 runs: gloo, both ranks on the same card;
    ``runs`` = [(name, config, steps)], each a Trainer of its own."""
    sys.path.insert(0, ROOT)
    from matcha_tpu_torch.parallel import mesh

    mesh.init_data_parallel(dev, backend="gloo", init_method=f"file://{store}", rank=rank, world_size=2)
    try:
        res = {name: dp_run(tmp, filelist, f"tp_{name}", cfg, dev, use_mesh=True, steps=steps, tensor_parallel=2)
               for name, cfg, steps in runs}
    finally:
        mesh.destroy()
    torch.save(res, os.path.join(tmp, f"tp_rank{rank}.pt"))


def phase_tp_train(tmp: str, dev: str = "cuda") -> dict:
    """Tensor-parallel training at the production operating point (v20
    widths, dropout 0, Adam eps 1e-3) over the 62 utterances of bucket
    512: one process against two spawned ranks dp 1 x tp 2 over gloo on
    this card.

    bf16, 3 steps: first-step loss 1e-5, later losses 1e-2 (dp_train's
    bounds), parameters 1e-5 after the first step; after the third, the
    parameters within 1e-5 plus the spread of the single process against
    itself (two runs here: the alignment search is discrete, and the
    backward's atomic sums move later steps' inputs).  fp32, 1 step: loss
    and parameters 1e-5, where rounding cannot move the alignment.  The
    tp=2 checkpoint reloads at tp=1 bit-equal."""
    import dataclasses

    import torch.multiprocessing as mp

    from matcha_tpu_torch.checkpoint import load_checkpoint
    from matcha_tpu_torch.train.checkpoint import train_state_from_tree

    cfg = v20_train_config(dropout=False)
    fp32 = dataclasses.replace(cfg, compute_dtype="float32")
    runs = [("bf16", cfg, 3), ("bf16_first", cfg, 1), ("fp32_first", fp32, 1)]
    filelist = short_corpus(tmp)
    single = {name: dp_run(tmp, filelist, f"tp_single_{name}", c, dev, use_mesh=False, steps=n)
              for name, c, n in runs}
    again = dp_run(tmp, filelist, "tp_single_again", cfg, dev, use_mesh=False, steps=3)
    t0 = time.perf_counter()
    mp.start_processes(tp_worker, args=(os.path.join(tmp, "tp_store"), tmp, filelist, runs, dev), nprocs=2,
                       join=True, start_method="spawn")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"tp_rank{r}.pt")) for r in range(2)]
    for run in (*single.values(), *(r[name] for r in ranks for name, _, _ in runs)):
        for n, sigs in run["signatures"].items():
            LAUNCHED.setdefault(n, set()).update(sigs)

    def rel(a, b):
        return abs(a - b) / abs(b)

    tp, one = ranks[0]["bf16"], single["bf16"]
    losses = [(r["loss"], s["loss"]) for r, s in zip(tp["steps"], one["steps"])]
    err = {"first_loss_rel_err": rel(*losses[0]), "loss_rel_err": max(rel(a, b) for a, b in losses),
           "first_step_param_max_abs_err": param_diff(ranks[0]["bf16_first"]["params"],
                                                      single["bf16_first"]["params"]),
           "param_max_abs_err": param_diff(tp["params"], one["params"]),
           "single_vs_itself_param_max_abs_err": param_diff(again["params"], one["params"]),
           "fp32_first_loss_rel_err": rel(ranks[0]["fp32_first"]["steps"][0]["loss"],
                                          single["fp32_first"]["steps"][0]["loss"]),
           "fp32_first_step_param_max_abs_err": param_diff(ranks[0]["fp32_first"]["params"],
                                                           single["fp32_first"]["params"])}
    ranks_equal = all(torch.equal(ranks[0][name]["params"][n], ranks[1][name]["params"][n])
                      for name, _, _ in runs for n in ranks[0][name]["params"])

    # the tp=2 checkpoint (rank 0, whole tensors) reloads at tp=1
    (ckpt,) = sorted(glob.glob(os.path.join(tp["out_dir"], "checkpoints", "epoch_*")))
    tree, ckpt_cfg = load_checkpoint(ckpt)
    params, _, step, _ = train_state_from_tree(tree, ckpt_cfg, "cpu")
    reload_equal = ckpt_cfg == cfg and step == 3 and all(
        torch.equal(params[n].detach(), tp["params"][n]) for n in params)

    def summary(run):
        return {"rank": run["rank"], "losses": [s["loss"] for s in run["steps"]],
                "step_s": [s["seconds"] for s in run["steps"]], "peak_memory_gib": run["peak_memory_gib"],
                "param_mib_on_rank": run["param_mib_on_rank"], "launches_per_step": run["steps"][-1]["launches"],
                "signatures": {n: [list(map(str, x)) for x in v] for n, v in run["signatures"].items()}}

    out = {"phase": "tp_train", "config": "v20-production, dropout 0", "adam_eps": DP_OPT["eps"],
           "decoder": {"channels": list(cfg.decoder.channels), "heads": cfg.decoder.num_heads,
                       "head_dim": cfg.decoder.attention_head_dim},
           "encoder_heads": cfg.encoder.n_heads, "single_bf16": summary(one), "single_bf16_again": summary(again),
           "tp2_gloo_bf16": [summary(r["bf16"]) for r in ranks], "spawn_s": spawn_s,
           "tp2_vs_single": err, "ranks_bit_identical": ranks_equal,
           "checkpoint_reloads_at_tp1_bit_equal": reload_equal,
           "tol": {"first_loss": 1e-5, "loss": 1e-2, "param": 1e-5,
                   "param_after_3": "1e-5 + single_vs_itself_param_max_abs_err"}}
    emit(out)
    want = step_launches(cfg)
    for run in (one, again, *(r["bf16"] for r in ranks)):
        check(all(s["launches"] == want for s in run["steps"]), f"a step launched other than {want}")
    for r in ranks:
        heads = {sig[0][1] for sig in r["bf16"]["signatures"]["masked_attention_fwd"]}
        check(heads == {cfg.decoder.num_heads // 2}, f"a tp rank launched K1 at heads {heads}, expected 3")
    check(ranks_equal, "the two tp ranks' gathered parameters differ")
    check(reload_equal, "the tp=2 checkpoint does not reload bit-equal at tp=1")
    check(err["first_loss_rel_err"] <= 1e-5 and err["loss_rel_err"] <= 1e-2, f"tp=2 bf16 losses: {err}")
    check(err["first_step_param_max_abs_err"][0] <= 1e-5, f"tp=2 bf16 first-step parameters: {err}")
    check(err["param_max_abs_err"][0] <= 1e-5 + err["single_vs_itself_param_max_abs_err"][0],
          f"tp=2 bf16 parameters after 3 steps: {err}")
    check(err["fp32_first_loss_rel_err"] <= 1e-5 and err["fp32_first_step_param_max_abs_err"][0] <= 1e-5,
          f"tp=2 fp32: {err}")
    out["launches"] = {n: sum(r["bf16"]["launches"][n] for r in ranks) for n in tp["launches"]}
    return out


def timed_steps(ts, state, batch, counters, steps: int, seed: int = 0) -> list[dict]:
    """``steps`` train steps, each synchronized and timed, with its launches."""
    records = []
    for _ in range(steps):
        torch.cuda.synchronize()
        before = {n: c.launches for n, c in counters.items()}
        t0 = time.perf_counter()
        state, m = ts.train_step(state, batch, seed)
        torch.cuda.synchronize()
        records.append({"seconds": time.perf_counter() - t0,
                        "launches": {n: c.launches - before[n] for n, c in counters.items()},
                        **{k: float(v) for k, v in m.items()}})
    return records


def phase_conformer(tmp: str, counters) -> dict:
    """The Conformer decoder at MatchaConfig() widths, bf16: B=1 fused and
    B=16 synthesis (K1 exactly 100 times a request), then 3 training steps
    of B=62 x 512 with dropout on."""
    import dataclasses

    from matcha_tpu_torch.train.optim import OptimizerConfig
    from matcha_tpu_torch.train.step import TrainStep

    synth = production_synthesizer("bfloat16", decoder={"block_type": "conformer"})
    check(synth.cfg.decoder.block_type == "conformer", "the synthesizer is not a Conformer one")
    for c in counters.values():
        c.reset()
    ids = ids_of(200, 1)
    synth.synthesise_ids(ids, scale_correction=1.0, fused=True)  # first call
    lat, per_request = [], []
    for _ in range(10):
        before = counters["masked_attention_fwd"].launches
        r = synth.synthesise_ids(ids, scale_correction=1.0, fused=True)
        per_request.append(counters["masked_attention_fwd"].launches - before)
        lat.append(r.latency_s)
        check_wav(r.wav, len(ids), "Conformer B=1 fused")
    lists = [ids_of(180 + 4 * i, 100 + i) for i in range(16)]
    mixes = [[(15, 1.0)]] * 16
    rtfs = []
    for _ in range(3):
        res = synth.synthesise_batch(lists, voice_mixes=mixes, fused=True)
        for ids_k, rk in zip(lists, res):
            check_wav(rk.wav, len(ids_k), "Conformer B=16 fused")
        rtfs.append(res[0].rtf)
    synthesis = read_counts(counters)
    del synth
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(bf16_train_config(), decoder=dataclasses.replace(
        bf16_train_config().decoder, block_type="conformer"))
    ts = TrainStep(cfg, OptimizerConfig(), device="cuda")
    state = ts.init_state(generator=torch.Generator().manual_seed(13))
    batch = fixed_batch(tmp, cfg, 62)
    for c in counters.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    steps = timed_steps(ts, state, batch, counters, 3)
    training = read_counts(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {"phase": "conformer", "compute_dtype": "bfloat16", "widths": "MatchaConfig()",
           "b1_fused_latency_ms_p50": statistics.median(lat) * 1e3, "b1_fused_latency_ms": [x * 1e3 for x in lat],
           "b16_fused_rtf_median": statistics.median(rtfs), "b16_fused_rtf": rtfs,
           "k1_per_request": per_request, "expected_k1_per_request": request_launches(cfg),
           "train_batch": list(batch.y.shape[:2]), "train_dropout": cfg.decoder.dropout,
           "train_losses": [s["loss"] for s in steps], "train_step_s": [s["seconds"] for s in steps],
           "train_peak_memory_gib": peak, "train_launches_per_step": steps[-1]["launches"],
           "launches": {"synthesis": synthesis, "training": training}}
    emit(out)
    check(all(n == request_launches(cfg) == 100 for n in per_request),
          f"Conformer requests launched K1 {per_request} times, expected 100 each")
    check(all(math.isfinite(s[k]) for s in steps for k in ("loss", "grad_norm")), "non-finite Conformer losses")
    want = step_launches(cfg)
    check(all(s["launches"] == want for s in steps), f"a Conformer step launched other than {want}")
    del ts, state
    torch.cuda.empty_cache()
    out["launches"] = {n: synthesis[n] + training[n] for n in synthesis}
    return out


def phase_remat(tmp: str, counters) -> dict:
    """The production training step (bf16, dropout on, B=62 x 512) with and
    without remat, on one batch from the same weights and seeds: loss
    equal, gradients within the non-remat step's run-to-run noise, peak
    memory and step time of each, K1 twice per decoder block with remat."""
    import dataclasses

    from matcha_tpu_torch.models.matcha import init_params
    from matcha_tpu_torch.train.optim import OptimizerConfig
    from matcha_tpu_torch.train.step import TrainStep

    base = bf16_train_config()
    params = init_params(base, torch.Generator().manual_seed(17))
    batch = fixed_batch(tmp, base, 62)
    runs = {}
    for name, remat in (("plain_a", False), ("plain_b", False), ("remat", True)):
        cfg = dataclasses.replace(base, decoder=dataclasses.replace(base.decoder, remat=remat))
        ts = TrainStep(cfg, OptimizerConfig(), device="cuda")
        seen = {}
        real = ts.opt.update

        def spy(p, g, st, seen=seen, real=real):
            seen.update({n: x.detach().clone() for n, x in g.items()})
            real(p, g, st)

        ts.opt.update = spy
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if name == "remat":
            for c in counters.values():
                c.reset()
        first = timed_steps(ts, ts.init_state(params), batch, counters, 1)
        grads = dict(seen)
        more = timed_steps(ts, ts.init_state(params), batch, counters, 2)
        if name == "remat":
            path = read_counts(counters)
        runs[name] = {"loss": first[0]["loss"], "grads": grads, "peak_memory_gib":
                      torch.cuda.max_memory_allocated() / 2**30,
                      "step_s": [s["seconds"] for s in first + more], "launches": first[0]["launches"]}
        del ts, seen
    noise_err, noise_worst = param_diff(runs["plain_b"]["grads"], runs["plain_a"]["grads"])
    remat_err, remat_worst = param_diff(runs["remat"]["grads"], runs["plain_a"]["grads"])
    plain_launch, remat_launch = runs["plain_a"]["launches"], runs["remat"]["launches"]
    dec = base.decoder
    blocks = dec.n_blocks * (2 * len(dec.channels) + dec.num_mid_blocks)
    want = dict(plain_launch, masked_attention_fwd=plain_launch["masked_attention_fwd"] + blocks)
    out = {"phase": "remat", "compute_dtype": "bfloat16", "batch": list(batch.y.shape[:2]),
           "dropout": base.decoder.dropout,
           "loss": {n: r["loss"] for n, r in runs.items()},
           "grad_max_abs_diff": {"plain_b_vs_plain_a": noise_err, "remat_vs_plain_a": remat_err},
           "grad_worst": {"plain_b_vs_plain_a": noise_worst, "remat_vs_plain_a": remat_worst},
           "peak_memory_gib": {n: r["peak_memory_gib"] for n, r in runs.items()},
           "step_s": {n: r["step_s"] for n, r in runs.items()},
           "launches_per_step": {"plain": plain_launch, "remat": remat_launch},
           "decoder_blocks": blocks, "rule": "remat gradient diff <= 2 x the plain step's diff against itself"}
    emit(out)
    check(runs["remat"]["loss"] == runs["plain_a"]["loss"] == runs["plain_b"]["loss"],
          f"losses differ: {out['loss']}")
    check(remat_err <= 2 * noise_err if noise_err > 0 else remat_err == 0.0,
          f"remat gradients {remat_err} ({remat_worst}) beyond the noise {noise_err}")
    check(remat_launch == want, f"a remat step launched {remat_launch}, expected {want}")
    out["launches"] = path
    return out


def phase_norm_stats() -> dict:
    """B=1 synthesis with the decoder's norm statistics in bf16 and in
    fp32: max |Δ| of the mel, fused p50 of each."""
    import numpy as np

    ids = ids_of(200, 1)
    res = {}
    for name, on in (("fp32_stats", False), ("bf16_stats", True)):
        synth = production_synthesizer("bfloat16", decoder={"bf16_norm_stats": on})
        mel = synth.synthesise_ids(ids, scale_correction=1.0, debug=True).mel
        synth.synthesise_ids(ids, scale_correction=1.0, fused=True)
        lat = [synth.synthesise_ids(ids, scale_correction=1.0, fused=True).latency_s for _ in range(10)]
        res[name] = {"mel": mel, "p50_ms": statistics.median(lat) * 1e3}
        del synth
        torch.cuda.empty_cache()
    a, b = res["fp32_stats"]["mel"], res["bf16_stats"]["mel"]
    check(a.shape == b.shape and np.isfinite(a).all() and np.isfinite(b).all(), "norm_stats mels")
    out = {"phase": "norm_stats", "compute_dtype": "bfloat16",
           "mel_max_abs_diff": float(np.abs(a - b).max()), "mel_abs_max": float(np.abs(a).max()),
           "b1_fused_p50_ms": {n: r["p50_ms"] for n, r in res.items()}}
    emit(out)
    check(out["mel_max_abs_diff"] > 0, "bf16 statistics left the mel unchanged: the switch is a no-op")
    return out


def phase_durations() -> dict:
    """The segment DP against K2+K3 at (62, 224, 1024): values on a 2^-12
    grid, so every sum either DP forms is exact in fp32 and the two agree
    unless two paths tie exactly; durations must be equal.  torch.cummax's
    tie rule (last index) on the card; times."""
    from matcha_tpu_torch.ops import mas

    gen = torch.Generator(device="cuda").manual_seed(8)
    b, tx, ty = 62, 224, 1024
    value = torch.round(torch.randn((b, tx, ty), generator=gen, device="cuda") * 4096) / 4096
    x_len = torch.randint(150, tx + 1, (b,), generator=gen, device="cuda")
    y_len = torch.minimum(4 * x_len + torch.randint(0, 200, (b,), generator=gen, device="cuda"),
                          torch.full_like(x_len, ty))
    seg = mas.maximum_path_durations(value, x_len, y_len)
    idx = mas.maximum_path_indices_kernel(value, x_len, y_len)
    ref = mas.durations_from_indices(idx, tx).to(torch.int32)
    torch.cuda.synchronize()
    equal = bool(torch.equal(seg, ref))
    tie_idx = torch.cummax(torch.tensor([[1.0, 1.0, 0.5, 1.0]], device="cuda"), dim=1).indices
    last_on_ties = tie_idx.tolist() == [[0, 1, 1, 3]]
    ms = cuda_ms(lambda: mas.maximum_path_durations(value, x_len, y_len), reps=5, per_rep=1, warmup=1)
    k23_ms = cuda_ms(lambda: mas.durations_from_indices(mas.maximum_path_indices_kernel(value, x_len, y_len), tx))
    nbytes = b * tx * ty * 4 + b * tx * 4
    out = {"phase": "durations", "shape": [b, tx, ty], "values": "N(0,1) on a 2^-12 grid",
           "equal_to_k2_k3": equal, "mismatches": int((seg != ref).sum()),
           "frames_partitioned": bool(torch.equal(seg.sum(1), y_len.to(torch.int32))),
           "cummax_last_index_on_ties": last_on_ties, "ms": ms, "k2_k3_and_durations_ms": k23_ms,
           "bytes_bound_ms": nbytes / PEAK_BYTES * 1e3}
    emit(out)
    check(equal and out["frames_partitioned"], f"segment DP durations differ from K2+K3 ({out['mismatches']})")
    check(last_on_ties, f"torch.cummax on the card took {tie_idx.tolist()} on ties, not the last index")
    return out


NEW_SIGNATURE_SHAPES = [(62, 6, 224, 48), (62, 6, 512, 64), (62, 3, 512, 64), (62, 3, 224, 48)]


# F5-TTS's DiT (16 heads of 64): the longest bucket of the f5-train cell's
# mix and a mid one, the ladder's neighbours of each
DIT_SIGNATURE_SHAPES = [(13, 16, 2816, 64), (13, 16, 2848, 64), (52, 16, 736, 64), (50, 16, 768, 64)]


# CosyVoice 2's estimator (8 heads of 64, chunk 50 on a streaming step): the
# cosy-train cell's longest bucket (20 × 1600), the sizing's 21 × 1504 and
# its median bucket (71 × 448)
COSY_SIGNATURE_SHAPES = [(20, 8, 1600, 64), (21, 8, 1504, 64), (71, 8, 448, 64)]
COSY_CHUNK = 50


def phase_chunked_attention() -> dict:
    """K1 (with and without lse) and K1b chunk-causal (chunk 50) at the
    flow estimator's shapes against the plain versions, then each timed at
    chunk 50 and at chunk 0 (all keys), beside its bound: the chunked
    bound counts only the (query, key) pairs the mask keeps."""
    from matcha_tpu_torch.ops import attention as att
    from matcha_tpu_torch.utils.flops import kept_pairs

    gen = torch.Generator(device="cuda").manual_seed(22)
    timed = {}
    for shape in COSY_SIGNATURE_SHAPES:
        b, h, t, d = shape
        for dtype in (torch.bfloat16, torch.float32):
            check_k1(shape, dtype, gen, chunk=COSY_CHUNK)
            check_k1_lse(shape, dtype, gen, chunk=COSY_CHUNK)
            check_bwd_alone(shape, dtype, gen, chunk=COSY_CHUNK)
        q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(4))
        u8 = torch.ones((b, t), device="cuda", dtype=torch.uint8)
        entry = {}
        for chunk in (COSY_CHUNK, 0):
            keys = kept_pairs(t, chunk) / t  # the mean keys a query sees
            fwd = cuda_ms(lambda: att._launch_fwd(q, k, v, u8, True, chunk=chunk))
            out, lse = att._launch_fwd(q, k, v, u8, True, chunk=chunk)
            bwd = cuda_ms(lambda: att.masked_attention_bwd_dkv(q, k, v, dout, lse, out, u8, chunk=chunk))
            fb = attention_bound_ms(b, h, t, d, torch.bfloat16, keys, with_lse=True)[0]
            bb = attention_bwd_bound_ms(b, h, t, d, torch.bfloat16, keys, products=5, tensors=8)[0]
            entry[f"chunk_{chunk}"] = {"fwd_lse_ms": fwd, "fwd_bound_ms": fb, "fwd_share": fb / fwd,
                                       "bwd_ms": bwd, "bwd_bound_ms": bb, "bwd_share": bb / bwd,
                                       "kept_pair_share": kept_pairs(t, chunk) / (t * t)}
        timed[shape] = entry
        emit({"phase": "kernel_time", "kernel": "masked_attention (chunk-causal)", "shape": list(shape),
              "dtype": "bfloat16", **entry})
        torch.cuda.empty_cache()
    return timed


def phase_new_signatures_time() -> dict:
    """K1 (with and without lse) and K1b at the encoder's training shape and
    at the new paths' signatures (v20 widths, and their tp=2 halves),
    against the plain versions, timed beside SDPA's forward and backward."""
    return time_signatures(NEW_SIGNATURE_SHAPES, "masked_attention (new signatures)")


def phase_dit_signatures_time() -> dict:
    """The same at the DiT's shapes (``DIT_SIGNATURE_SHAPES``)."""
    return time_signatures(DIT_SIGNATURE_SHAPES, "masked_attention (DiT)")


def time_signatures(shapes, label: str) -> dict:
    """K1 (with and without lse) and K1b at ``shapes``, each checked against
    its plain version, timed beside the plain versions and SDPA."""
    import torch.nn.functional as F

    from matcha_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(12)
    timed = {}
    for shape in shapes:
        check_k1(shape, torch.bfloat16, gen)
        check_k1_lse(shape, torch.bfloat16, gen)
        check_bwd_alone(shape, torch.bfloat16, gen)
        b, h, t, d = shape
        q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(4))
        valid = torch.ones((b, t), device="cuda")
        u8 = valid.to(torch.uint8)
        keep = valid[:, None, None, :] > 0
        entry = {}
        for with_lse in (False, True):
            bound = attention_bound_ms(b, h, t, d, torch.bfloat16, t, with_lse)
            entry["fwd_lse" if with_lse else "fwd"] = {
                "ms": cuda_ms(lambda: att._launch_fwd(q, k, v, u8, with_lse)), "bound_ms": bound[0],
                "bound_by": bound[1]}
        entry["fwd_plain_ms"] = cuda_ms(lambda: att.masked_self_attention_plain(q, k, v, valid))
        entry["sdpa_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep))
        out, lse = att._launch_fwd(q, k, v, u8, with_lse=True)
        bwd_ms = cuda_ms(lambda: att.masked_attention_bwd_dkv(q, k, v, dout, lse, out, u8))
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        plain_out = att.masked_self_attention_plain(qg, kg, vg, valid)
        entry["bwd_plain_ms"] = cuda_ms(lambda: torch.autograd.grad(plain_out, (qg, kg, vg), dout,
                                                                    retain_graph=True))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
        entry["sdpa_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout,
                                                                   retain_graph=True))
        # all launches of the backward (pre-pass, fused pass, post-pass)
        entry["bwd"] = bwd_entry(b, h, t, d, bwd_ms, entry["sdpa_bwd_ms"])
        timed[shape] = entry
        emit({"phase": "kernel_time", "kernel": label, "shape": list(shape), "dtype": "bfloat16", **entry})
        del plain_out, lib_out
        torch.cuda.empty_cache()
    return timed



def phase_path_signatures() -> dict:
    """Every kernel against its plain version at every signature a main
    path launched it at (``LAUNCHED``): random inputs at that shape and
    dtype, ragged key lengths, K1 with or without lse as launched, the
    backward kernels in both dtypes' tolerances, MAS on ragged and tied
    values."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {"masked_attention_fwd": 0.0, "lse": 0.0, "masked_attention_bwd": 0.0}
    for shape, dtype, with_lse, chunk in sorted(LAUNCHED["masked_attention_fwd"]):
        if with_lse:
            err, lse_err = check_k1_lse(shape, getattr(torch, dtype), gen, at="path", chunk=chunk)
            worst["lse"] = max(worst["lse"], lse_err)
        else:
            err = check_k1(shape, getattr(torch, dtype), gen, at="path", chunk=chunk)
        worst["masked_attention_fwd"] = max(worst["masked_attention_fwd"], err)
    bwd = sorted(LAUNCHED["masked_attention_bwd"])
    for shape, dtype, chunk in bwd:
        worst["masked_attention_bwd"] = max(worst["masked_attention_bwd"],
                                            check_bwd_alone(shape, getattr(torch, dtype), gen, at="path",
                                                            chunk=chunk))
    for shape in sorted(LAUNCHED["mas"]):
        for kind in ("ragged", "ties"):
            check_mas(shape, gen, kind, at="path")
    out = {"phase": "path_signatures",
           "signatures": {"masked_attention_fwd": [list(x) for x in sorted(LAUNCHED["masked_attention_fwd"])],
                          "masked_attention_bwd": [list(x) for x in bwd],
                          "mas": [list(x) for x in sorted(LAUNCHED["mas"])]},
           "worst": worst}
    emit(out)
    return worst


# ---------------------------------------------------------------------------
# the hardware parity tier: the production operating point against the JAX
# package's CPU fp32 oracle
# ---------------------------------------------------------------------------

def phase_hw_parity(counters) -> dict:
    """utils/hw_parity.py at full width against tests/data/
    torch_e2e_oracle.npz (the JAX package's CPU fp32 and bf16 runs on the
    drawn weights, whose fingerprints are asserted): fp32 two-stage on the
    card, bf16 two-stage and fused, one training step in bf16 and one in
    fp32, each held to the JAX tier's bars (``hw_parity.bar_misses``); the
    launches of each run held to their exact numbers."""
    from matcha_tpu_torch.utils import hw_parity as hp

    for c in counters.values():
        c.reset()
    out = hp.parity_readings("cuda")
    total = read_counts(counters)
    cfg, _ = hp.configs("bfloat16")
    per_request = {"masked_attention_fwd": request_launches(cfg)}
    want = {"fp32_two_stage": per_request, "bf16_two_stage": per_request, "bf16_fused": per_request,
            "bf16_train_step": step_launches(cfg, deterministic=True),
            "fp32_train_step": step_launches(cfg, deterministic=True)}
    misses = hp.bar_misses(out)
    out = {"phase": "hw_parity", **out, "launches": total, "bar_misses": misses,
           "tf32": [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32],
           "bars": {"fp32_mcd_db": hp.MEL_MCD_FP32_BAR_DB, "bf16_mcd_db": hp.MEL_MCD_BF16_BAR_DB,
                    "fused_mcd_db": hp.FUSED_MCD_BAR_DB, "duration_max_diff": hp.DURATION_MAX_DIFF,
                    "duration_fraction": hp.DURATION_DIFF_FRACTION, "train_loss_rtol": hp.TRAIN_LOSS_RTOL,
                    "update_l1_rtol": hp.UPDATE_L1_RTOL}}
    emit(out)
    check(out["tf32"] == [False, False], "TF32 is on: the fp32 run's products were not true fp32")
    for name, counts in want.items():
        for kernel, n in counts.items():
            got = out["launches_by_run"][name][kernel]
            check(got == n, f"{name} launched {kernel} {got} times, not {n}")
    check(not misses, f"hardware parity bars missed: {misses}")
    return out


def phase_bucket_invariance(counters, smi: str) -> dict:
    """tests/test_torch_fused_parting.py's walk on the card at the parity
    point (full width, bf16, speaker 2, 40 ids): the decode at decoder
    T=128 (the two-stage bucket) and T=256 (the fused one) with forward
    hooks, every module of its 8 U-Net evaluations compared on the valid
    frames, the first that differs named with its evaluation and max |Δ| /
    max |ref| (``null`` when none does); the request's fused against
    two-stage audio, mel MCD and wav max |Δ|, held to the tier's bar; with
    the fp32 and the bf16 norm statistics (``hw_parity.bucket_readings``).
    K1 counted exactly: 4 for stage A, 96 a walked decode, 100 a request."""
    from matcha_tpu_torch.utils import hw_parity as hp

    t0 = time.perf_counter()
    for c in counters.values():
        c.reset()
    runs = hp.bucket_readings("cuda")
    del runs["threads"]
    launches = read_counts(counters)
    cfg, _ = hp.configs("bfloat16")
    want = 2 * (cfg.encoder.n_layers + 2 * 8 * unet_launches(cfg) + 2 * request_launches(cfg))
    out = {"phase": "bucket_invariance", "nvidia_smi": smi, **runs, "bar_db": hp.FUSED_MCD_BAR_DB,
           "launches": launches, "seconds": time.perf_counter() - t0}
    emit(out)
    check(launches["masked_attention_fwd"] == want,
          f"bucket_invariance launched K1 {launches['masked_attention_fwd']} times, not {want}")
    for name, r in runs.items():
        check(r["wav_samples"][0] == r["wav_samples"][1], f"{name}: fused and two-stage lengths differ")
        check(r["mcd_db"] < hp.FUSED_MCD_BAR_DB,
              f"{name}: fused against two-stage {r['mcd_db']:.4g} dB, first parting {r['first_parting']}")
    return out


# ---------------------------------------------------------------------------
# the reference's own checkpoints served with no JAX, the native batch
# loader, the measuring modules
# ---------------------------------------------------------------------------

def v20_hparams():
    """configs/experiment/v20-production.yaml's model section as a Lightning
    checkpoint's ``hyper_parameters``, nested as namespaces."""
    from types import SimpleNamespace as NS

    return NS(
        n_spks=16, n_feats=100, spk_emb_dim=96,
        encoder=NS(encoder_params=NS(n_feats=100, n_channels=192, filter_channels=1152, n_heads=6, n_layers=4,
                                     kernel_size=5, p_dropout=0.05, prenet=True, prenet_kernel_size=3),
                   duration_predictor_params=NS(filter_channels_dp=96, kernel_size=5, p_dropout=0.05, n_layers=4)),
        decoder=NS(channels=[384, 384], dropout=0.05, attention_head_dim=64, n_blocks=2, num_mid_blocks=2,
                   num_heads=6),
        cfm=NS(name="CFM", solver="midpoint", sigma_min=1e-4, use_mu_prior=True),
        data_statistics=NS(mel_mean=-4.684777, mel_std=6.512275),
        optimizer=None, scheduler=None, prior_loss=True, prior_loss_threshold=0.15, duration_loss_threshold=0.3)


def speech_request(url: str, ids, fmt: str):
    """One /v1/audio/speech request for ``ids`` as ``fmt``: (status, body)."""
    import urllib.error
    import urllib.request

    body = json.dumps({"phoneme_ids": ids, "voice": "15", "response_format": fmt}).encode()
    req = urllib.request.Request(url + "/v1/audio/speech", data=body, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def libopus_present() -> bool:
    """Whether ``dlopen`` finds libopus, as the native encoder looks for it."""
    import ctypes

    for name in ("libopus.so.0", "libopus.so"):
        try:
            ctypes.CDLL(name)
            return True
        except OSError:
            continue
    return False


def phase_reference_ckpt(tmp: str, counters) -> dict:
    """The reference's own checkpoint formats served with no JAX, at v20
    widths: a Lightning ``.ckpt`` (seeded random weights in the reference
    layout, every other decoder name under ``_orig_mod.``, the statistics
    buffers, hparams as namespaces) and an HF Vocos ``pytorch_model.bin``
    (``backbone.embed`` weight-normed, the ISTFT window beside it) through
    the port's two converter CLIs; ``load_synthesizer`` on their outputs;
    the loaded weights bit-equal to the checkpoints' own; one B=1 fused
    request, bit-equal to a synthesizer built straight from the weights the
    checkpoints were made from, and one server request as WAV and one as
    Ogg/Opus.  The counts are set to 0 just before each request and read
    just after: K1 exactly ``request_launches`` (100) times each."""
    import dataclasses
    from http.server import ThreadingHTTPServer

    import numpy as np

    from matcha_tpu_torch import convert_matcha_ckpt, convert_vocos
    from matcha_tpu_torch.checkpoint import load_synthesizer
    from matcha_tpu_torch.inference import MatchaSynthesizer
    from matcha_tpu_torch.models.matcha import init_params
    from matcha_tpu_torch.serving.server import TTSService, make_handler
    from matcha_tpu_torch.vocoder.vocos import VocosConfig, init_vocos_params

    root = os.path.join(tmp, "reference_ckpt")
    os.makedirs(root, exist_ok=True)
    want = dataclasses.replace(v20_train_config(), compute_dtype="float32")
    gen = torch.Generator().manual_seed(20)
    sd = init_params(want, gen)
    sd["encoder.proj_w.proj.weight"].zero_()  # 4 fine frames a token, as production_synthesizer
    sd["encoder.proj_w.proj.bias"].fill_(math.log(6.0))
    e = "decoder.estimator."
    lightning = {(e + "_orig_mod." + k[len(e):] if k.startswith(e) and i % 2 else k): v
                 for i, (k, v) in enumerate(sd.items())}
    lightning["mel_mean"], lightning["mel_std"] = torch.tensor(-4.684777), torch.tensor(6.512275)
    ckpt_path, bin_path = os.path.join(root, "last.ckpt"), os.path.join(root, "pytorch_model.bin")
    torch.save({"state_dict": lightning, "hyper_parameters": v20_hparams(), "epoch": 0, "global_step": 0},
               ckpt_path)
    vcfg = VocosConfig()
    vsd = init_vocos_params(vcfg, gen)
    # the weight-normed conv's weight is drawn so that its fold g·v/‖v‖ is
    # exact in fp32: each row holds 676 entries ±2^e and zeros, so
    # ‖v‖ = 26·2^e.  The direct build then takes the weight itself, which
    # no converter touched, and must still be bit-equal
    shape = vsd.pop("backbone.embed.weight").shape
    rows, fan_in = shape[0], math.prod(shape[1:])
    keep = torch.rand(rows, fan_in, generator=gen).argsort(dim=1) < 676
    signs = torch.randint(0, 2, (rows, fan_in), generator=gen).float() * 2 - 1
    w = (signs * keep * torch.pow(2.0, torch.randint(-6, -3, (rows, 1), generator=gen).float())).reshape(shape)
    vsd["backbone.embed.parametrizations.weight.original0"] = w.flatten(1).norm(dim=1).reshape(-1, 1, 1)
    vsd["backbone.embed.parametrizations.weight.original1"] = w
    vsd["head.istft.window"] = torch.hann_window(vcfg.n_fft)
    torch.save(vsd, bin_path)

    t0 = time.perf_counter()
    convert_matcha_ckpt.main(["--input", ckpt_path, "--output", os.path.join(root, "converted"), "--strict"])
    convert_vocos.main(["--input", bin_path, "--output", os.path.join(root, "vocos.pkl")])
    convert_s = time.perf_counter() - t0
    synth = load_synthesizer(os.path.join(root, "converted"), os.path.join(root, "vocos.pkl"), device="cuda")
    check(synth.cfg.to_dict() == want.to_dict(), f"derived config is not v20's: {synth.cfg}")
    check(synth.vocos_cfg == vcfg, f"derived Vocos config {synth.vocos_cfg}")
    # the direct build takes the weights the checkpoints were made from, the
    # Vocos weight that went in as a weight-norm parametrization included;
    # none of it passes through the converters
    plain_vocos = {k: v for k, v in vsd.items() if ".parametrizations." not in k and k != "head.istft.window"}
    plain_vocos["backbone.embed.weight"] = w
    weights_equal = {}
    for name, module, own in (("matcha", synth.model, sd), ("vocos", synth.vocos, plain_vocos)):
        loaded = module.state_dict()
        weights_equal[name] = sorted(loaded) == sorted(own) and all(
            torch.equal(loaded[k].cpu(), v) for k, v in own.items())
    check(all(weights_equal.values()), f"converted weights differ from the checkpoints' own: {weights_equal}")
    direct = MatchaSynthesizer(want, sd, plain_vocos, vcfg, device="cuda")

    ids = ids_of(200, 1)
    check(synth.predict_fine_bucket(256, 1.0) == 1024, "production bucket is not 1024")
    direct.synthesise_ids(ids, scale_correction=1.0, fused=True)  # first calls: allocator, cuDNN
    ref = direct.synthesise_ids(ids, scale_correction=1.0, fused=True)
    synth.synthesise_ids(ids, scale_correction=1.0, fused=True)
    per_request = request_launches(want)
    for c in counters.values():
        c.reset()
    got = synth.synthesise_ids(ids, scale_correction=1.0, fused=True)
    launches = {"fused": read_counts(counters)}
    check_wav(got.wav, len(ids), "reference_ckpt B=1 fused")
    bit_equal = bool(got.wav.shape == ref.wav.shape and np.array_equal(got.wav, ref.wav))
    check(bit_equal, "the converted checkpoint's audio differs from the direct build's")
    del direct

    service = TTSService(synth, use_batcher=True)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    served = {}
    try:
        service.warmup()
        for fmt in ("wav", "ogg"):
            for c in counters.values():
                c.reset()
            status, data = speech_request(url, ids, fmt)
            launches[fmt] = read_counts(counters)
            served[fmt] = {"status": status, "bytes": len(data), "magic": data[:4].decode("latin-1"),
                           **({} if status == 200 else {"body": data[:200].decode("utf-8", "replace")})}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        if service.batcher is not None:
            service.batcher.shutdown()
    check(served["wav"]["status"] == 200 and served["wav"]["magic"] == "RIFF", f"WAV response {served['wav']}")
    # the encoder dlopens libopus when it encodes; where the machine has none
    # the server must say so (500 naming libopus), and the Ogg path is not
    # exercised here
    served["ogg"]["libopus"] = libopus_present()
    if served["ogg"]["libopus"]:
        check(served["ogg"]["status"] == 200 and served["ogg"]["magic"] == "OggS", f"Ogg response {served['ogg']}")
    else:
        check(served["ogg"]["status"] == 500 and "libopus" in served["ogg"]["body"], f"Ogg response {served['ogg']}")
    for what, counts in launches.items():
        check(counts["masked_attention_fwd"] == per_request == 100,
              f"{what}: K1 launched {counts['masked_attention_fwd']} times, expected {per_request}")
        check(all(counts[n] == 0 for n in counts if n != "masked_attention_fwd"), f"{what}: {counts}")
    out = {"phase": "reference_ckpt", "derived_config": {
               "decoder": [list(want.decoder.channels), want.decoder.num_heads, want.decoder.attention_head_dim],
               "encoder_heads": want.encoder.n_heads, "spk_emb_dim": want.spk_emb_dim, "n_spks": want.n_spks,
               "compute_dtype": synth.cfg.compute_dtype, "equals_v20": True},
           "convert_s": convert_s, "weights_equal": weights_equal,
           "bit_equal_to_direct_build": bit_equal, "b1_fused_latency_ms": got.latency_s * 1e3,
           "wav_samples": len(got.wav), "served": served, "launches": launches}
    emit(out)
    del synth
    torch.cuda.empty_cache()
    return {"launches": {n: sum(c[n] for c in launches.values()) for n in counters}}


def phase_native_train(tmp: str, counters) -> dict:
    """The training path with the native batch loader: a ``Trainer`` on the
    card (which takes the loader, built from ``native/src``) over phase
    train's corpus at 32,000 frames a batch, 3 steps, the counts set to 0
    just before and read just after; one batch of the native collate held
    equal to ``collate_numpy``'s; the collate time per batch of each route
    and the step times (host clock, no claim); the Ogg/Opus encoder bound
    from the same built library."""
    import numpy as np

    from matcha_tpu_torch.data import native_loader
    from matcha_tpu_torch.data.collate import collate, collate_numpy
    from matcha_tpu_torch.data.dataset import TextMelDataset
    from matcha_tpu_torch.train.optim import OptimizerConfig
    from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig
    from matcha_tpu_torch.utils import opus_converter

    cfg = bf16_train_config()
    ds = TextMelDataset(os.path.join(tmp, "train.csv"), os.path.join(tmp, "mels"), cfg.n_feats)
    tcfg = TrainerConfig(output_dir=os.path.join(tmp, "native_run"), max_epochs=-1, log_every_n_steps=1,
                         checkpoint_every_n_epochs=100, seed=4321)
    trainer = Trainer(cfg, OptimizerConfig(), tcfg, ds, max_frames_per_batch=32000, len_bucket=32)
    check(trainer.dm.use_native is True and native_loader.loaded(), "the trainer on the card took no native loader")
    steps, real_step = [], trainer.train_step

    def timed_step(state, batch, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = real_step(state, batch, seed)
        torch.cuda.synchronize()
        steps.append({"batch": list(batch.y.shape[:2]), "seconds": time.perf_counter() - t0,
                      "loss": float(metrics["loss"])})
        return state, metrics

    trainer.train_step = timed_step
    native_loader.fill_batch_count.reset()
    for c in counters.values():
        c.reset()
    try:
        trainer.fit(max_steps=3)
    finally:
        trainer.close()
    launches = read_counts(counters)
    fills = native_loader.fill_batch_count.launches
    check(len(steps) == 3 and all(math.isfinite(r["loss"]) for r in steps), f"steps {steps}")
    check(fills >= 2 * len(steps), f"the native loader filled {fills} arrays for {len(steps)} batches")
    per_step = step_launches(cfg)
    check(launches == {n: len(steps) * per_step[n] for n in per_step},
          f"3 native-loader steps launched {launches}, expected 3 x {per_step}")

    plans = trainer.sampler.create_batches(0)
    native = collate(ds, plans[0], 32, use_native=True)
    reference = collate_numpy(ds, plans[0], 32)
    check(native.y.is_pinned() and native.y_fine.is_pinned(), "the native batch's mels are not pinned")
    equal = all(torch.equal(a, torch.from_numpy(b)) for a, b in zip(native, reference))
    check(equal, "the native collate differs from collate_numpy")
    collate_s = {"native": [], "numpy": []}
    for rep in range(3):
        for plan in plans:
            for route in (("native", "numpy") if rep % 2 == 0 else ("numpy", "native")):
                t0 = time.perf_counter()
                collate(ds, plan, 32, use_native=route == "native")
                collate_s[route].append(time.perf_counter() - t0)

    lib = opus_converter._load()
    check(lib is not None and lib._name == str(native_loader.library_path()),
          "the Ogg/Opus encoder did not bind the library built from native/src")
    tone = np.sin(np.arange(24000, dtype=np.float32) * 0.05) * 0.5
    if libopus_present():
        ogg = opus_converter.waveform_to_opus_ogg(tone)
        check(ogg[:4] == b"OggS", "the Ogg/Opus encoder wrote no Ogg stream")
        ogg = {"bytes": len(ogg)}
    else:  # the loader loaded without libopus; the encoder must name what is missing
        try:
            opus_converter.waveform_to_opus_ogg(tone)
            ogg = {"error": None}
        except RuntimeError as exc:
            ogg = {"error": str(exc)}
        check(ogg["error"] is not None and "libopus" in ogg["error"], f"encoding without libopus: {ogg}")
    out = {"phase": "native_train", "native_path": True, "fill_batch_calls": fills,
           "library": os.path.relpath(native_loader.library_path(), ROOT), "batch_equal_to_numpy": equal,
           "batch": list(native.y.shape[:2]), "steps": steps,
           "median_step_s": statistics.median(r["seconds"] for r in steps),
           "collate_ms_per_batch": {r: statistics.median(v) * 1e3 for r, v in collate_s.items()},
           "collate_ms_all": {r: [x * 1e3 for x in v] for r, v in collate_s.items()},
           "host_numbers": "host clock on a shared host; no claim", "libopus": libopus_present(), "ogg": ogg,
           "launches": launches}
    emit(out)
    del trainer
    torch.cuda.empty_cache()
    return out


def decode_stage(synth, lists, tx: int = 256, y_fine_len: int = 1024):
    """Stage B (decode) of ``synth`` for ``lists`` at the production bucket:
    the encoder's outputs on the card, and ``fn(acc, *inputs)`` that decodes
    with ``mu_x`` perturbed by ``acc`` and returns the whole waveform's sum
    (the probe's honesty rule)."""
    from matcha_tpu_torch.inference import DEFAULT_NUM_STEPS, DEFAULT_ODE_SOLVER

    rep = synth.replicas[0]
    host = synth._stage_a_inputs(lists, [[(15, 1.0)]] * len(lists), [1.0] * len(lists), len(lists), tx)
    mu_x, durations, x_mask = rep.encode(*(t.to(rep.device) for t in host))
    lengths = torch.clamp(durations.sum(dim=1).to(torch.int64), 2, y_fine_len)

    def body(acc, mu_x, durations, x_mask, lengths):
        _, wav, _ = rep.decode(mu_x + acc, durations, x_mask, lengths, y_fine_len=y_fine_len,
                               n_timesteps=DEFAULT_NUM_STEPS, solver=DEFAULT_ODE_SOLVER)
        return wav.float().sum() * 1e-12

    return body, (mu_x, durations, x_mask, lengths)


def phase_measure(synth, profile) -> dict:
    """The port's measuring modules on the card: ``probe.inner_repeat`` (one
    CUDA-graph replay of the chain) on the decode stage at B=1 and B=16
    production, beside ``trace_analysis.device_stats`` of one traced
    decode; ``device_stats`` of a profiled B=1 fused request beside phase
    profile's ``device_breakdown`` busy time; ``wait_for_backend`` on a live
    card.  Outside every counted window: a probe's kernels count once, at
    capture."""
    from matcha_tpu_torch.utils import probe, profiling, trace_analysis
    from matcha_tpu_torch.utils.backend_wait import wait_for_backend

    out = {"phase": "measure"}
    points = {"decode_b1": [ids_of(200, 1)], "decode_b16": [ids_of(180 + 4 * i, 100 + i) for i in range(16)]}
    for name, lists in points.items():
        body, inputs = decode_stage(synth, lists)
        probed = probe.inner_repeat(body, *inputs, k=4, reps=5)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as logdir:
            with profiling.trace(logdir):
                body(torch.zeros((), device="cuda"), *inputs)
            traced = trace_analysis.device_stats(logdir)
        check(probed["device_ms"] > 0 and traced["device_busy_ms"] > 0, f"{name}: {probed}, {traced['device_busy_ms']}")
        out[name] = {"probe": probed, "trace_busy_ms": traced["device_busy_ms"],
                     "trace_wall_span_ms": traced["wall_span_ms"], "trace_device_events": traced["device_events"],
                     "probe_over_trace": probed["device_ms"] / traced["device_busy_ms"] if traced["device_busy_ms"] else None}
    ids = ids_of(200, 1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as logdir:
        with profiling.trace(logdir):
            synth.synthesise_ids(ids, scale_correction=1.0, fused=True)
        fused = trace_analysis.device_stats(logdir)
    check(fused["device_busy_ms"] > 0 and fused["device_planes"], f"no device time in the trace: {fused['device_planes']}")
    out["fused_b1"] = {"trace_busy_ms": fused["device_busy_ms"], "trace_wall_span_ms": fused["wall_span_ms"],
                       "device_events": fused["device_events"], "device_planes": fused["device_planes"],
                       "device_breakdown_busy_ms": profile["b1_fused"]["device_busy_ms"],
                       "top": [[n[:60], m] for n, m in list(fused["modules"].items())[:3]]}
    t0 = time.perf_counter()
    wait_for_backend()
    out["wait_for_backend_s"] = time.perf_counter() - t0
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the measuring entry points: the benchmark and the two profilers, each run
# in-process through its main() as a user runs it
# ---------------------------------------------------------------------------

def run_main(main, argv) -> tuple[int, list[str]]:
    """``main(argv)`` with its standard output captured: (exit code, lines)."""
    import contextlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().strip().splitlines()


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def phase_bench() -> dict:
    """``python -m matcha_tpu_torch.bench`` at 5 timed B=16 calls: the parity
    line with no bar missed, then the headline with bench.py's keys, an MFU
    in (0, 1) from the analytic count, spreads, the device's idle shares and
    the audio's device→host copy.  Outside every counted window: its probe
    counts kernels once, at capture."""
    from matcha_tpu_torch import bench

    t0 = time.perf_counter()
    rc, lines = run_main(bench.main, ["--iters", "5"])
    seconds = time.perf_counter() - t0
    check(rc == 0 and len(lines) == 2, f"bench exited {rc} with {len(lines)} lines")
    parity, result = json.loads(lines[0]), json.loads(lines[1])
    out = {"phase": "bench", "seconds": seconds, **result}
    emit(out)
    check(parity["bar_misses"] == [], f"bench: parity bars missed: {parity['bar_misses']}")
    keys = ("metric", "value", "unit", "vs_baseline", "headline_path", "mfu", "mfu_flops_source",
            "latency_p50_b1_ms", "latency_p50_b1_fused_ms", "fused_b16", "two_stage_b16_rtf", "stage_breakdown",
            "device_breakdown", "fused_b1", "device", "spread_ms", "device_idle_share", "device_events_per_call",
            "device_probe", "durations")
    check(all(k in result for k in keys), f"bench: missing keys {[k for k in keys if k not in result]}")
    check(result["mfu_flops_source"] == "analytic" and finite(result["mfu"]) and 0 < result["mfu"] < 1,
          f"bench: mfu {result['mfu']}")
    check(result["headline_path"] == "fused_single_dispatch_b16" and finite(result["value"]) and result["value"] > 0,
          f"bench: headline {result['headline_path']} {result['value']}")
    shares = list(result["device_idle_share"].values())
    check(all(finite(x) and 0 <= x < 1 for x in shares), f"bench: idle shares {shares}")
    check(finite(result["device_breakdown"]["d2h_copy_ms"]), "bench: no device-to-host copy in the B=16 trace")
    probe = result["device_probe"]
    check(probe["device_decode_ms"] > 0 and probe["device_encode_ms"] > 0, f"bench: probe {probe}")
    check(result["spread_ms"]["latency_b1_fused"]["n"] >= 20, "bench: fewer than 20 B=1 repeats")
    return out


def phase_profile_stage_b() -> dict:
    """``utils/profile_stage_b`` at the B=16 headline point, every
    component: each one a CUDA-graph replay (a component that cannot be
    captured raises), its scalar finite; stage_b within 15 % of ode + vocos
    + align."""
    from matcha_tpu_torch.utils import profile_stage_b

    rc, lines = run_main(profile_stage_b.main, ["--batch", "16", "--components", "all"])
    check(rc == 0, f"profile_stage_b exited {rc}")
    result = json.loads(lines[-1])
    out = {"phase": "profile_stage_b", **result}
    emit(out)
    for name in profile_stage_b.ALL_COMPONENTS:
        entry = result[name]
        check(finite(entry["scalar"]) and finite(entry["device_ms"]), f"profile_stage_b {name}: {entry}")
    parts = sum(result[n]["device_ms"] for n in ("ode", "vocos", "align"))
    check(abs(result["stage_b"]["device_ms"] - parts) <= 0.15 * parts,
          f"stage_b {result['stage_b']['device_ms']} ms against its parts' {parts} ms")
    return out


def phase_profile_step() -> dict:
    """``utils/profile_step`` at the production bucket B=62 x 512: finite
    step times and losses, real frames a second, peak memory, the trace's
    busy time and idle share, an MFU in (0, 1)."""
    from matcha_tpu_torch.utils import profile_step

    rc, lines = run_main(profile_step.main, ["--batch", "62", "--tx", "224", "--frames", "512", "--iters", "5"])
    check(rc == 0, f"profile_step exited {rc}")
    result = json.loads(lines[-1])
    out = {"phase": "profile_step", **result}
    emit(out)
    check(finite(result["mfu"]) and 0 < result["mfu"] < 1, f"profile_step: mfu {result['mfu']}")
    check(finite(result["coarse_frames_per_s"]) and result["peak_memory_gib"] > 0, "profile_step: rates")
    trace = result["device_trace"]
    check(trace["device_busy_ms_per_step"] > 0 and 0 <= trace["idle_share"] < 1, f"profile_step: trace {trace}")
    return out


# ---------------------------------------------------------------------------
# the chip A/B tools and the live-serving measurements: the two A/B tools
# in-process (counted windows), the two server tools booting the port's
# server in subprocesses (their launches are not counted)
# ---------------------------------------------------------------------------

def ab_decodes(k: int = 4) -> int:
    """Decodes of one probed point: the mel, then inner_repeat's two warm-up
    calls and its captures of 1 and k (a capture counts its launches once)."""
    return 1 + 2 + 1 + k


def json_report(lines: list[str]) -> dict:
    """A tool's indented JSON report, from its captured standard output."""
    return json.loads("\n".join(lines))


def phase_ab_fast_solvers(counters) -> dict:
    """``utils/ab_fast_solvers`` at B=16, text 256, fine 1024, bf16: each
    point's device time (a CUDA-graph replay of the chain) and mel MCD
    finite; midpoint/4 against itself at the MCD floor (0: the decode is
    deterministic); euler/4 and midpoint/2 under 0.65 x midpoint/4's device
    time (4 U-Net evaluations against 8); K1 launched exactly as counted:
    the encoder once, then every decode of every point."""
    from matcha_tpu_torch.models.config import MatchaConfig
    from matcha_tpu_torch.utils import ab_fast_solvers as ab

    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    rc, lines = run_main(ab.main, [])
    seconds = time.perf_counter() - t0
    launches = read_counts(counters)
    check(rc == 0, f"ab_fast_solvers exited {rc}")
    result = json_report(lines)
    cfg = MatchaConfig()
    evals = ab.unet_evals(*ab.REFERENCE) + ab_decodes() * sum(ab.unet_evals(*p) for p in ab.POINTS)
    want = cfg.encoder.n_layers + evals * unet_launches(cfg)
    out = {"phase": "ab_fast_solvers", "seconds": seconds, **result, "launches": launches,
           "expected_k1_launches": want}
    emit(out)
    pts = result["points"]
    for key, p in pts.items():
        check(finite(p["device_ms"]) and p["device_ms"] > 0 and finite(p["mel_mcd_vs_midpoint4_db"]),
              f"ab_fast_solvers {key}: {p}")
    check(pts["midpoint/4"]["mel_mcd_vs_midpoint4_db"] == 0.0,
          f"midpoint/4 against itself reads {pts['midpoint/4']['mel_mcd_vs_midpoint4_db']} dB: the decode is "
          f"not deterministic (mel max |diff| {pts['midpoint/4']['mel_max_abs_diff_vs_midpoint4']})")
    ref_ms = pts["midpoint/4"]["device_ms"]
    for key in ("euler/4", "midpoint/2"):
        check(pts[key]["device_ms"] < 0.65 * ref_ms, f"{key} {pts[key]['device_ms']} ms is not under 0.65 x {ref_ms}")
    check(result["totals"] == [1024, 1024], f"the bucket is not full of speech: totals {result['totals']}")
    check(launches["masked_attention_fwd"] == want, f"ab_fast_solvers launched K1 {launches['masked_attention_fwd']}"
          f" times, expected {want}")
    return out


LAYOUT_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # max |nwc - ncw| / max |ncw|; bf16: an output ulp


def phase_ab_stage_b_levers(counters) -> dict:
    """``utils/ab_stage_b_levers`` at the same point: levers a (bf16 norm
    statistics) and c (the fp32 carry) with finite device times and a mel
    MCD > 0 (0 would mean the switch was a no-op), lever b's convs finite
    beside their bounds; the two layouts' outputs equal within LAYOUT_TOL
    in bf16 (the tool's reading) and in fp32 (here, TF32 off); K1 launched
    exactly as counted (per lever: one encode, two synthesizers' probed
    decodes)."""
    from matcha_tpu_torch.models.config import MatchaConfig
    from matcha_tpu_torch.utils import ab_stage_b_levers as lv

    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    rc, lines = run_main(lv.main, [])
    seconds = time.perf_counter() - t0
    launches = read_counts(counters)
    result = json_report(lines)
    cfg = MatchaConfig()
    want = 2 * (cfg.encoder.n_layers + 2 * ab_decodes() * 8 * unet_launches(cfg))
    fp32 = {}
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        for name, t, cin, cout, kernel, stride in lv.CONV_CASES:
            x, conv, x_ncw, ncw = lv.conv_case(lv.B, t, cin, cout, kernel, stride, torch.float32, "cuda")
            fp32[name] = lv.layout_rel_diff(conv(x), ncw(x_ncw))
    out = {"phase": "ab_stage_b_levers", "seconds": seconds, **result, "launches": launches,
           "expected_k1_launches": want, "layout_fp32_max_rel_diff": fp32,
           "layout_tol": {str(k): v for k, v in LAYOUT_TOL.items()}}
    emit(out)
    check(rc == 0, f"ab_stage_b_levers exited {rc}: {lv.check_report(result)}")
    for name, entry in result["lever_b_conv_layout"].items():
        check(finite(entry["nwc_ms"]) and finite(entry["ncw_ms"]) and entry["bound_ms"] > 0, f"{name}: {entry}")
        check(entry["ncw_vs_nwc_max_rel_diff"] <= LAYOUT_TOL[torch.bfloat16], f"{name} bf16 layouts differ: {entry}")
        check(fp32[name] <= LAYOUT_TOL[torch.float32], f"{name} fp32 layouts differ by {fp32[name]}")
    check(launches["masked_attention_fwd"] == want,
          f"ab_stage_b_levers launched K1 {launches['masked_attention_fwd']} times, expected {want}")
    return out


def serve_artifacts(tmp: str) -> dict:
    """The checkpoint and Vocos pickle the serving phases share (made once,
    at production width, by ``utils/live_serving_ab.ensure_artifacts``)."""
    return {"AB_CKPT": os.path.join(tmp, "serve_ckpt"), "AB_VOCOS": os.path.join(tmp, "serve_vocos.pkl")}


LIVE_LADDER = "1,2,4,8,16"


def phase_live_serving_path(tmp: str, counters) -> dict:
    """The live legs' serving path in this process, in a counted window:
    the artifacts the legs serve, loaded as the server loads them (text
    buckets 64,128), a ``TTSService`` with the legs' ladder 1..16 warmed
    and groups of up to 16, then ``psr/load_test.py --ids`` (20 users, 6 s)
    over HTTP and one group of each ladder size at text bucket 128, once
    with SERVE_FUSED=0 and once with 1.  K1 launches
    exactly: the encoder's layers per encode and per fused call, the
    decoder's blocks per U-Net evaluation of every decode and fused call;
    its signatures join ``LAUNCHED``, so ``phase_path_signatures`` holds K1
    against its plain version at the shapes the legs give it."""
    from http.server import ThreadingHTTPServer
    from unittest import mock

    from matcha_tpu_torch.checkpoint import load_synthesizer
    from matcha_tpu_torch.serving.server import TTSService, make_handler
    from matcha_tpu_torch.utils import live_serving_ab as live

    paths = serve_artifacts(tmp)
    live.ensure_artifacts(paths["AB_CKPT"], paths["AB_VOCOS"])
    synth = load_synthesizer(paths["AB_CKPT"], paths["AB_VOCOS"], text_buckets=(64, 128), device="cuda")
    cfg = synth.cfg
    calls = {"encode": 0, "decode_evals": 0, "fused": 0, "fused_evals": 0}
    rows = set()

    def evals(kw) -> int:
        return kw["n_timesteps"] * (2 if kw["solver"] == "midpoint" else 1)

    def counted(name):
        real = getattr(synth, name)

        def run(*args, **kw):
            if name == "_run_encode":
                calls["encode"] += 1
                rows.add(int(args[0][0].shape[0]))
            elif name == "_run_decode":
                calls["decode_evals"] += evals(kw)
            else:
                calls["fused"] += 1
                calls["fused_evals"] += evals(kw)
                rows.add(int(args[0][0].shape[0]))
            return real(*args, **kw)
        return run

    for name in ("_run_encode", "_run_decode", "_run_fused"):
        setattr(synth, name, counted(name))
    t0 = time.perf_counter()
    cells = {}
    for c in counters.values():
        c.reset()
    for fused in ("0", "1"):
        env = dict(SERVE_FUSED=fused, BATCHER_MAX_BATCH="16", BATCHER_MAX_WAIT_MS="15",
                   WARMUP_BATCH_SIZES=LIVE_LADDER, WARMUP_FULL="0", WARMUP_PROGRESSIVE="0")
        with mock.patch.dict(os.environ, env):  # read at construction and by warmup
            service = TTSService(synth, use_batcher=True)
            httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            try:
                service.warmup()
                proc = subprocess.run(
                    [sys.executable, "psr/load_test.py", "--host", f"http://127.0.0.1:{httpd.server_address[1]}",
                     "--users", "20", "--minutes", "0.1", "--ids"],
                    capture_output=True, text=True, cwd=ROOT, timeout=300)
                # then every group size of the ladder at the load test's
                # longest request (110 ids, voice 2: text bucket 128), as
                # the batcher calls it, so that each (group, bucket) the
                # legs can reach is launched here whatever the load grouped
                for b in map(int, LIVE_LADDER.split(",")):
                    synth.synthesise_batch([ids_of(110, 300 + b)] * b, voice_mixes=[[(2, 1.0)]] * b,
                                           fused=fused == "1")
            finally:
                httpd.shutdown()
                httpd.server_close()
                thread.join(timeout=30)
                service.batcher.shutdown()
        cell = live.parse_report(proc.stdout)
        cells[f"fused_{fused}"] = dict(cell, failure=live.cell_failure(proc.stdout, cell))
    launches = read_counts(counters)
    want = (cfg.encoder.n_layers * (calls["encode"] + calls["fused"])
            + unet_launches(cfg) * (calls["decode_evals"] + calls["fused_evals"]))
    out = {"phase": "live_serving_path", "seconds": time.perf_counter() - t0, "cells": cells, "calls": calls,
           "group_rows": sorted(rows), "launches": launches, "expected_k1_launches": want,
           "k1_signatures": [list(x) for x in sorted(counters["masked_attention_fwd"].signatures)]}
    emit(out)
    for key, cell in cells.items():
        check(cell["failure"] is None and finite(cell["p50_ms"]) and finite(cell["p95_ms"]), f"{key}: {cell}")
    check(calls["fused"] > 0 and calls["decode_evals"] > 0, f"both serving programs ran: {calls}")
    check(launches["masked_attention_fwd"] == want,
          f"the live serving path launched K1 {launches['masked_attention_fwd']} times, expected {want}")
    check(all(launches[n] == 0 for n in launches if n != "masked_attention_fwd"), f"live serving path: {launches}")
    del synth
    torch.cuda.empty_cache()
    return out


def phase_live_serving(tmp: str) -> dict:
    """``utils/live_serving_ab`` at legs 8,16 x fused 0,1, 20 users for 10 s a
    cell, text buckets 64,128: the port's server booted in a subprocess per
    leg (kernels prebuilt here), ``psr/load_test.py --ids`` against it;
    every leg ok > 0, no error, finite p50/p95.  The servers' K1 launches
    happen in their processes, outside every counted window;
    ``phase_live_serving_path`` drives the same path in this process."""
    from unittest import mock

    from matcha_tpu_torch.utils import live_serving_ab

    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, AB_LEGS="8,16", AB_FUSED="0,1", AB_USERS="20", AB_MINUTES="0.17",
                         AB_PORT=str(free_port()), TEXT_BUCKETS="64,128", **serve_artifacts(tmp)):
        rc, lines = run_main(live_serving_ab.main, [])
    result = json_report(lines)
    out = {"phase": "live_serving", "seconds": time.perf_counter() - t0, **result}
    emit(out)
    check(rc == 0 and result["ok"], f"live_serving_ab exited {rc}: {result.get('failed')}")
    check(result["kernels_prebuilt"] and len(result["legs"]) == 4, f"live_serving legs {len(result['legs'])}")
    check(result["widths"] == live_serving_ab.WIDTHS[False], f"served widths {result['widths']}")
    for leg in result["legs"]:
        cell = leg["users_20"]
        check(cell["ok"] > 0 and cell["errors"] == 0 and finite(cell["p50_ms"]) and finite(cell["p95_ms"]),
              f"leg b={leg['max_batch']} fused={leg['fused']}: {cell}")
    return out


def phase_progressive_boot(tmp: str) -> dict:
    """``utils/measure_progressive_boot``: the port's server with
    WARMUP_PROGRESSIVE=1 (ladder 1..16, text buckets 64,128) healthy no
    later than fully warm (true by construction, the JAX tool's check);
    the gate opened early: /health answered 200 while it still said
    "warming", and a request served then answered 200 with a WAV; the
    full-warmup boot's time to healthy and the gain recorded (one boot
    each: reported, not held, as boot-to-boot noise is of its size)."""
    from unittest import mock

    from matcha_tpu_torch.utils import measure_progressive_boot

    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, AB_PORT=str(free_port()), TEXT_BUCKETS="64,128", **serve_artifacts(tmp)):
        rc, lines = run_main(measure_progressive_boot.main, [])
    result = json_report(lines)
    out = {"phase": "progressive_boot", "seconds": time.perf_counter() - t0, **result}
    emit(out)
    check(rc == 0 and result["ok"], f"measure_progressive_boot exited {rc}: {result.get('failed')}")
    check(result["healthy_s"] <= result["fully_warm_s"], f"healthy {result['healthy_s']} > warm {result['fully_warm_s']}")
    check(result["health_body_at_ready"].get("warming") is True,
          f"/health said 200 only once the ladder was warm: {result['health_body_at_ready']}")
    warm = result.get("request_during_warm")
    check(warm is not None and warm["status"] == 200 and warm["wav"], f"request during warmup: {warm}")
    check(finite(result["full_warmup"]["healthy_s"]) and finite(result["healthy_gain_s"]),
          f"full warmup: {result['full_warmup']}")
    return out


def kernel_entry(name, source, replaces, launches, max_abs_err, timed, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": f"matcha_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": max_abs_err,
            "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"], "library_ms": timed["library_ms"], **extra}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from matcha_tpu_torch.ops.attention import masked_attention_fwd_count

    dev = phase_device()
    phase_build()
    k1 = phase_kernels()
    kt = phase_training_kernels()
    bwd_alone = phase_bwd_kernels()
    new_sigs = phase_new_signatures_time()
    phase_dit_signatures_time()
    phase_chunked_attention()
    phase_kernel_attributes()
    adamw = phase_adamw()
    dit_fused = phase_dit_fused()
    counters = train_counters()

    # main path 1: synthesis (model + server), counts read just after
    synth = production_synthesizer("bfloat16")
    for c in counters.values():
        c.reset()
    phase_model(synth, masked_attention_fwd_count)
    phase_server(synth)
    synthesis = read_counts(counters)
    check(synthesis["masked_attention_fwd"] > 0, "the synthesis path never launched masked_attention_fwd")
    profile = phase_profile(synth)
    phase_measure(synth, profile)
    del synth
    torch.cuda.empty_cache()
    # the measuring entry points, outside every counted window
    phase_bench()
    phase_profile_stage_b()
    phase_profile_step()
    torch.cuda.empty_cache()
    phase_reference()

    phase_mel_frontend()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # main path 2: training (Trainer over a synthetic corpus), counts read just after
        for c in (*counters.values(), *adamw_counters().values()):
            c.reset()
        phase_train(tmp)
        training = read_counts(counters)
        training_adamw = sum(c.launches for c in adamw_counters().values())
        for n, count in training.items():
            check(count > 0, f"the training path never launched {n}")
        phase_train_learns(tmp)
        phase_train_reference(tmp)
        phase_train_profile(tmp)
        native = {"native_train": phase_native_train(tmp, counters)["launches"]}

        # the voice-building tools: each phase sets the counts to 0 just
        # before its path and reads them just after
        tools = {"corpus_prep": phase_corpus_prep(tmp, counters)["launches"],
                 "finetune_speaker": phase_finetune_speaker(tmp, counters)["launches"],
                 "style_encoder": phase_style_encoder(tmp, counters)["launches"],
                 "add_speaker": phase_add_speaker(tmp, counters)["launches"],
                 "cli_mcd": phase_cli_mcd(tmp, counters)["launches"]}

        # checkpoints across frameworks, then data parallelism (the world-1
        # NCCL run's launches are the path's; both ranks' signatures join
        # the path checks)
        phase_checkpoint_crossing(tmp)
        tools["dp_train"] = phase_dp_train(tmp)["launches"]

        # tensor parallelism at the production operating point (the spawned
        # ranks count their own launches), then the decoder's switches
        tools["tp_train"] = phase_tp_train(tmp)["launches"]
        tools["conformer"] = phase_conformer(tmp, counters)["launches"]
        tools["remat"] = phase_remat(tmp, counters)["launches"]
        tools["reference_ckpt"] = phase_reference_ckpt(tmp, counters)["launches"]
        tools.update(native)
    for c in counters.values():
        c.reset()
    phase_norm_stats()
    tools["norm_stats"] = read_counts(counters)
    phase_durations()

    # seeded noise and the serving fan-out (it sets the counts to 0 itself)
    synth = production_synthesizer("bfloat16")
    phase_seeded_noise(synth)
    tools["fanout"] = phase_fanout(synth, counters)["launches"]
    del synth
    torch.cuda.empty_cache()

    # the hardware parity tier and the walk across mel buckets (each sets
    # the counts to 0 itself)
    tools["hw_parity"] = phase_hw_parity(counters)["launches"]
    tools["bucket_invariance"] = phase_bucket_invariance(counters, dev["nvidia_smi"])["launches"]

    # the chip A/B tools in-process (each sets the counts to 0 itself), then
    # the live-serving tools, whose servers run K1 in their own processes
    tools["ab_fast_solvers"] = phase_ab_fast_solvers(counters)["launches"]
    tools["ab_stage_b_levers"] = phase_ab_stage_b_levers(counters)["launches"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        tools["live_serving"] = phase_live_serving_path(tmp, counters)["launches"]
        phase_live_serving(tmp)
        phase_progressive_boot(tmp)

    on_path = phase_path_signatures()
    paths = {"synthesis": synthesis, "training": training, **tools}
    by_path = {n: {p: launches[n] for p, launches in paths.items()} for n in counters}
    total = {n: sum(v.values()) for n, v in by_path.items()}

    prod = k1["timed"][(16, 5, 512, 64)]
    bwd = kt["timed"][(62, 5, 512, 64)]
    mas_t = kt["timed"][(62, 224, 1024)]
    bwd_err = max(*kt["max_rel_err"].values(), *bwd_alone.values(), on_path["masked_attention_bwd"])
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": [
        kernel_entry("masked_attention_fwd", "masked_attention_fwd.cu",
                     "jax/experimental/pallas/ops/tpu/flash_attention.py:589",
                     total["masked_attention_fwd"], max(k1["max_abs_err"], on_path["masked_attention_fwd"]),
                     prod, shape=[16, 5, 512, 64], dtype="bfloat16",
                     lse_max_abs_err=max(k1["lse_max_abs_err"], on_path["lse"]),
                     launches_by_path=by_path["masked_attention_fwd"],
                     launches_not_counted=("phases bench, profile_stage_b, profile_step (in-process, outside "
                                           "every counted window); live_serving and progressive_boot (in the "
                                           "server subprocesses they boot; live_serving_path drives the same "
                                           "serving path in-process and is counted under live_serving)"),
                     ms_at_new_signatures={str(list(sh)): {"no_lse": e["fwd"]["ms"], "lse": e["fwd_lse"]["ms"],
                                                           "sdpa": e["sdpa_fwd_ms"]}
                                           for sh, e in new_sigs.items()}),
        kernel_entry("masked_attention_bwd", "masked_attention_bwd.cu",
                     "jax/experimental/pallas/ops/tpu/flash_attention.py:941 and :1287 "
                     "(_flash_attention_bwd_dkv, _flash_attention_bwd_dq)",
                     total["masked_attention_bwd"], bwd_err, bwd,
                     shape=[62, 5, 512, 64], dtype="bfloat16", error="max |err| / max |ref|",
                     plain_and_library="whole backward (dq, dk, dv)",
                     ms_includes="the delta pre-pass, the fused pass and the dq post-pass",
                     launches_by_path=by_path["masked_attention_bwd"],
                     ms_at_new_signatures={str(list(sh)): e["bwd"]["ms"] for sh, e in new_sigs.items()}),
        kernel_entry("mas", "mas.cu", "matcha_tpu/ops/mas_pallas.py:179,189",
                     total["mas"], 0.0, mas_t, shape=[62, 224, 1024], dtype="float32",
                     error="indices equal to the plain version", launches_by_path=by_path["mas"]),
        kernel_entry("adamw", "adamw.cu", "none (XLA fused matcha_tpu/train/optim.py's optax chain)",
                     {"training": training_adamw}, max(max(r["max_rel"].values()) for r in adamw["runs"].values()),
                     adamw, elements=adamw["elements"], dtype="float32",
                     error="max |err| / max |ref| of p's change, mu, nu and the norm against the loop",
                     launches_note="adamw_norm and adamw_update wrapper calls, one each a training step"),
        *[{"name": f"dit_{name}", "route": "cuda", "source": "matcha_tpu_torch/ops/csrc/dit_fused.cu",
           "replaces": "none (the JAX package has no DiT)",
           "launches": {"dit_fused_step": dit_fused["step"]["launches"]},
           "max_rel_err": max(sh["errors"][name] for sh in dit_fused["shapes"].values()),
           "shape": [13, 2848], **dit_fused["shapes"]["13x2848"]["timed"][name], "bound_by": "bytes",
           "library_ms": None} for name in dit_fused["shapes"]["13x2848"]["timed"]],
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
