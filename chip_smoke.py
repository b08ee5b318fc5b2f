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
  9. train_learns  20 steps on one fixed B=4 batch must cut the loss 10 %
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

The launch counters are set to 0 just before each main path (phases 4-5,
synthesis; phase 8, training; each of phases 13-17) and read just after:
the kernels line reports those launches, by path.  The last line is
``{"ok": true, "device": {...}}``.
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
    from matcha_tpu_torch.ops.extension import kernels

    t0 = time.perf_counter()
    kernels()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3)})


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


def check_k1(shape, dtype, gen, at="list") -> float:
    """K1 without lse at ``shape`` (ragged key lengths) through the wrapper
    and, in bf16, each layout alone, against the plain version: max |err|."""
    from matcha_tpu_torch.ops import attention as att

    valid, lengths = ragged_valid(shape[0], shape[2], gen)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    ref = att.masked_self_attention_plain(q.float(), k.float(), v.float(), valid)
    runs = {"wrapper": lambda: att.masked_attention_fwd(q, k, v, valid)}
    if dtype == torch.bfloat16:
        u8 = valid.to(torch.uint8)
        runs.update({f"layout_{n}": (lambda n=n: att._launch_fwd(q, k, v, u8, False, layout=n)[0])
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
          "dtype": str(dtype).split(".")[-1], "shapes_from": at, "key_lengths": lengths.tolist()[:8],
          "max_abs_err": errs, "tol": TOL[dtype], "ok": ok})
    check(ok, f"masked_attention_fwd disagrees with its plain version at {shape} {dtype}: {errs}")
    return err


def check_k1_lse(shape, dtype, gen, at="list") -> tuple[float, float]:
    """K1 with lse at ``shape``, each bf16 layout alone, against the plain
    output and lse; with B > 1 one batch row has no valid key (+inf lse,
    NaN output).  Returns (max |err| of the output, of the lse)."""
    from matcha_tpu_torch.ops import attention as att

    valid, lengths = ragged_valid(shape[0], shape[2], gen, empty_row=shape[0] > 1)
    u8 = valid.to(torch.uint8)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    ref = att.masked_self_attention_plain(q.float(), k.float(), v.float(), valid)
    ref_lse = att.masked_attention_lse_plain(q, k, valid)
    finite, keep = torch.isfinite(ref_lse), ~torch.isnan(ref)
    worst, worst_lse = 0.0, 0.0
    for layout in ((1, 2) if dtype == torch.bfloat16 else (0,)):
        out, lse = att._launch_fwd(q, k, v, u8, True, layout=layout)
        torch.cuda.synchronize()
        inf_same = bool(torch.equal(torch.isinf(lse), ~finite) and (lse[~finite] > 0).all())
        nan_same = bool(torch.equal(torch.isnan(out), ~keep))
        lse_err = (lse[finite] - ref_lse[finite]).abs().max().item()
        err = (out.float()[keep] - ref[keep]).abs().max().item()
        ok = inf_same and nan_same and lse_err <= LSE_TOL and err <= TOL[dtype]
        emit({"phase": "kernel_check", "kernel": "masked_attention_fwd_lse", "shape": list(shape),
              "dtype": str(dtype).split(".")[-1], "layout": layout, "shapes_from": at,
              "key_lengths": lengths.tolist()[:4], "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
              "empty_row_lse_inf": inf_same, "empty_row_out_nan": nan_same,
              "max_abs_err": err, "tol": TOL[dtype], "ok": ok})
        check(ok, f"K1's lse or output disagrees at {shape} {dtype} layout {layout}: lse {lse_err}, "
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


def production_synthesizer(compute_dtype: str, attention_backend: str = "auto", seed: int = 0):
    """Full-width MatchaConfig + VocosConfig with random weights from a seeded
    generator.  The duration head is set to a constant 4 fine frames per
    token (log(2 + 4)): random log-durations collapse to the 1-frame floor,
    which would make every request far shorter than speech."""
    import dataclasses

    from matcha_tpu_torch.inference import MatchaSynthesizer
    from matcha_tpu_torch.models.config import MatchaConfig
    from matcha_tpu_torch.models.matcha import init_params
    from matcha_tpu_torch.vocoder.vocos import VocosConfig, init_vocos_params

    cfg = dataclasses.replace(MatchaConfig(), compute_dtype=compute_dtype,
                              attention_backend=attention_backend)
    vcfg = VocosConfig(compute_dtype=compute_dtype)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen)
    params["encoder.proj_w.proj.weight"].zero_()
    params["encoder.proj_w.proj.bias"].fill_(math.log(6.0))
    return MatchaSynthesizer(cfg, params, init_vocos_params(vcfg, gen), vcfg)


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

    from matcha_tpu_torch.serving.server import TTSService, make_handler

    os.environ["BATCHER_MAX_WAIT_MS"] = "200"  # let the two concurrent requests meet
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
    """One ``run()`` under torch.profiler: the device's busy time (union of
    kernel and copy intervals), the attention kernel's share of it, each
    named kernel's time, launches and share, and the kernels that take the
    most time.  Host wall time is taken with the profiler off, around the
    same call ending in a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end, by_name = 0.0, -math.inf, {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    attention_us = sum(t for n, t in by_name.items() if "masked_attention_fwd" in n)
    attention_n = sum(1 for _, _, n in spans if "masked_attention_fwd" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy_ms = busy_us / 1e3
    named = {}
    for pattern in kernels:
        us = sum(t for n, t in by_name.items() if pattern in n)
        named[pattern] = {"ms": us / 1e3, "launches": sum(1 for _, _, n in spans if pattern in n),
                          "share_of_busy": us / busy_us if busy_us else None}
    return {"wall_ms": wall_ms, "device_events": len(spans), "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if spans else None,
            "attention_ms": attention_us / 1e3, "attention_launches": attention_n,
            "attention_share_of_busy": attention_us / busy_us if busy_us else None,
            "kernels": named, "top_kernels_ms": [[n[:90], t / 1e3] for n, t in top]}


def phase_profile(synth) -> dict:
    """Where the time of the main path goes on the device, B=1 and B=16."""
    ids = ids_of(200, 1)
    lists = [ids_of(180 + 4 * i, 100 + i) for i in range(16)]
    mixes = [[(15, 1.0)]] * 16
    out = {"phase": "profile",
           "b1_fused": device_breakdown(lambda: synth.synthesise_ids(ids, scale_correction=1.0, fused=True)),
           "b16_fused": device_breakdown(lambda: synth.synthesise_batch(lists, voice_mixes=mixes, fused=True))}
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
        delta = (dout.float() * out.float()).sum(-1)
        dkv_ms = cuda_ms(lambda: att.masked_attention_bwd_dkv(q, k, v, dout, lse, delta, valid_u8))
        dq_ms = cuda_ms(lambda: att.masked_attention_bwd_dq(q, k, v, dout, lse, delta, valid_u8))
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        plain_out = att.masked_self_attention_plain(qg, kg, vg, valid)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(plain_out, (qg, kg, vg), dout, retain_graph=True))
        keep = valid[:, None, None, :] > 0
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
        library_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout, retain_graph=True))
        product_flops = 2 * b * h * t * t * d
        entry = {"plain_ms": plain_ms, "library_ms": library_ms}
        for name, ms, products, tensors in (("masked_attention_bwd_dkv", dkv_ms, 4, 6),
                                            ("masked_attention_bwd_dq", dq_ms, 3, 5)):
            bound = attention_bwd_bound_ms(b, h, t, d, torch.bfloat16, t, products, tensors)
            entry[name] = dict(ms=ms, bound_ms=bound[0], bound_by=bound[1],
                               tflops=products * product_flops / (ms * 1e-3) / 1e12,
                               earlier_ms=EARLIER_MS[shape][name])
        pair_bound = attention_bwd_bound_ms(b, h, t, d, torch.bfloat16, t, products=5, tensors=8)
        entry["pair"] = dict(ms=dkv_ms + dq_ms, bound_ms=pair_bound[0], bound_by=pair_bound[1],
                             earlier_ms=sum(EARLIER_MS[shape].values()),
                             vs_library=(dkv_ms + dq_ms) / library_ms)
        timed[shape] = entry
        emit({"phase": "kernel_time", "kernel": "masked_attention_bwd", "shape": list(shape),
              "dtype": "bfloat16", "plain_and_library": "whole backward (dq, dk, dv)",
              "tflops": "products each kernel computes (dkv 4, dq 3) over its time",
              "earlier_ms": "the mma.sync kernels this design replaced (PERF.md)", **timed[shape]})
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
# device times of the mma.sync backward kernels the wgmma ones replaced, on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel table)
EARLIER_MS = {(62, 5, 512, 64): {"masked_attention_bwd_dkv": 0.3526, "masked_attention_bwd_dq": 0.1857},
              (29, 5, 1088, 64): {"masked_attention_bwd_dkv": 0.6636, "masked_attention_bwd_dq": 0.3382}}


def rel_err(got, ref) -> float:
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def check_bwd_alone(shape, dtype, gen, at="list") -> float:
    """Each backward kernel alone at ``shape`` against
    ``masked_attention_bwd_plain``, fed the log-sum-exp the forward kernel
    wrote (itself held against ``masked_attention_lse_plain``); ragged key
    lengths including 1.  Keys past a row's length must get dk = dv = 0
    exactly.  Returns the worst max |err| / max |ref| of dq, dk, dv."""
    from matcha_tpu_torch.ops import attention as att

    b, h, t, d = shape
    lengths = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
    lengths[0], lengths[-1] = 1, t
    valid = (torch.arange(t, device="cuda")[None] < lengths[:, None]).float()
    valid_u8 = valid.to(torch.uint8)
    padded = (valid_u8 == 0)[:, None, :, None].expand(b, h, t, d)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    out, lse = att._launch_fwd(q, k, v, valid_u8, with_lse=True)
    delta = (dout.float() * out.float()).sum(-1)
    dk, dv = att.masked_attention_bwd_dkv(q, k, v, dout, lse, delta, valid_u8)
    dq = att.masked_attention_bwd_dq(q, k, v, dout, lse, delta, valid_u8)
    torch.cuda.synchronize()
    lse_err = (lse - att.masked_attention_lse_plain(q, k, valid)).abs().max().item()
    ref = att.masked_attention_bwd_plain(q.float(), k.float(), v.float(), dout.float(), lse, delta, valid)
    errs = {f"d{n}": rel_err(g, r) for n, g, r in zip("qkv", (dq, dk, dv), ref)}
    pad_zero = bool((dk[padded] == 0).all() and (dv[padded] == 0).all())
    ok = (lse_err <= LSE_TOL and pad_zero
          and all(math.isfinite(e) and e <= TOL[dtype] for e in errs.values()))
    emit({"phase": "kernel_check", "kernel": "masked_attention_bwd_alone", "shape": list(shape),
          "dtype": str(dtype).split(".")[-1], "shapes_from": at, "key_lengths": lengths.tolist()[:4],
          "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL, "rel_err": errs, "tol": TOL[dtype],
          "padded_keys_zero": pad_zero, "ok": ok})
    check(ok, f"a backward kernel disagrees with masked_attention_bwd_plain at {shape} {dtype}: "
              f"lse {lse_err}, {errs}, padded keys zero: {pad_zero}")
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
    out = {f"{name}_d{d}": ext.masked_attention_bwd_attributes(name, d)
           for name in ("dkv", "dq") for d in (64, 128)}
    out.update({f"fwd_layout{n}_d{d}": ext.masked_attention_fwd_attributes(n, d)
                for n in (1, 2) for d in (64, 128)})
    out.update({f"mas_{tx}x{ty}": ext.mas_attributes(tx, ty) for tx, ty in ((224, 1024), (448, 2176), (513, 700))})
    emit({"phase": "kernel_attributes", **out})
    return out


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
            "masked_attention_bwd_dq": att.masked_attention_bwd_dq_count,
            "masked_attention_bwd_dkv": att.masked_attention_bwd_dkv_count,
            "mas": mas.mas_count}


# every signature (shapes, dtype, lse) at which a main path launched each
# kernel, gathered by read_counts and checked by phase_path_signatures
LAUNCHED: dict[str, set] = {}


def read_counts(counters) -> dict:
    """The launches since the counts were set to 0; each kernel's launch
    signatures join ``LAUNCHED``."""
    for n, c in counters.items():
        LAUNCHED.setdefault(n, set()).update(c.signatures)
    return {n: c.launches for n, c in counters.items()}


def request_launches(cfg) -> int:
    """K1 launches of one served request: the encoder's layers plus the
    decoder's transformer blocks in each of the 8 U-Net evaluations of
    midpoint/4 (4 + 8 x 12 = 100 at production widths)."""
    dec = cfg.decoder
    return cfg.encoder.n_layers + 8 * dec.n_blocks * (2 * len(dec.channels) + dec.num_mid_blocks)


def step_launches(cfg) -> dict:
    """Launches of one training step: K1 and both K1b kernels once per
    decoder transformer block (the encoder's attention takes the plain
    path under dropout), MAS once."""
    dec = cfg.decoder
    n_attn = dec.n_blocks * (2 * len(dec.channels) + dec.num_mid_blocks)
    return {"masked_attention_fwd": n_attn, "masked_attention_bwd_dq": n_attn,
            "masked_attention_bwd_dkv": n_attn, "mas": 1}


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
    tcfg = TrainerConfig(output_dir=os.path.join(tmp, "run"), max_epochs=-1, log_every_n_steps=1,
                         checkpoint_every_n_epochs=100, seed=1234)
    trainer = Trainer(cfg, OptimizerConfig(), tcfg, TextMelDataset(filelist, mel_dir),
                      max_frames_per_batch=32000, len_bucket=32)
    records = []
    real_step = trainer.train_step

    def timed_step(state, batch, seed):
        torch.cuda.synchronize()
        before = {n: c.launches for n, c in counters.items()}
        t0 = time.perf_counter()
        state, metrics = real_step(state, batch, seed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        real_frames = int((batch.y_lengths.float() * batch.weights).sum())
        records.append({"step": state.step, "batch": list(batch.y.shape[:2]),
                        "text_bucket": batch.x.shape[1], "seconds": seconds,
                        "coarse_frames": real_frames,
                        "launches": {n: c.launches - before[n] for n, c in counters.items()},
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


def fixed_batch(tmp: str, cfg, b: int):
    """``b`` utterances of the 512 bucket, collated, on the card."""
    from matcha_tpu_torch.data.collate import collate
    from matcha_tpu_torch.data.dataset import TextMelDataset
    from matcha_tpu_torch.data.sampler import BucketPlan

    ds = TextMelDataset(os.path.join(tmp, "train.csv"), os.path.join(tmp, "mels"), cfg.n_feats)
    return collate(ds, BucketPlan(mel_len=512, batch_size=b, indices=list(range(b)), n_real=b),
                   text_bucket=32).to("cuda")


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
    losses = []
    for _ in range(20):
        state, m = ts.train_step(state, batch, 0, deterministic=True, cfm_t_noise=t_noise)
        losses.append(float(m["loss"]))
    drop = 1.0 - losses[-1] / losses[0]
    out = {"phase": "train_learns", "batch": list(batch.y.shape[:2]), "losses": losses,
           "relative_drop": drop, "required": 0.10}
    emit(out)
    check(all(math.isfinite(x) for x in losses) and drop >= 0.10,
          f"the loss fell {drop:.3f} in 20 steps, less than 10 %")
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
    per_step = {"masked_attention_fwd": 8, "masked_attention_bwd_dq": 4, "masked_attention_bwd_dkv": 4, "mas": 0}
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
    check(prof_launches == {"masked_attention_fwd": 8, "attn_bwd_dq": 4, "attn_bwd_dkv": 4, "mas_kernel": 0},
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
    want = {"masked_attention_fwd": 2 * request_launches(cfg), "masked_attention_bwd_dq": 0,
            "masked_attention_bwd_dkv": 0, "mas": 0}
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
    want = {"masked_attention_fwd": 2 * request_launches(bf16_train_config()), "masked_attention_bwd_dq": 0,
            "masked_attention_bwd_dkv": 0, "mas": 0}
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


def phase_path_signatures() -> dict:
    """Every kernel against its plain version at every signature a main
    path launched it at (``LAUNCHED``): random inputs at that shape and
    dtype, ragged key lengths, K1 with or without lse as launched, the
    backward kernels in both dtypes' tolerances, MAS on ragged and tied
    values."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {"masked_attention_fwd": 0.0, "lse": 0.0, "masked_attention_bwd": 0.0}
    for shape, dtype, with_lse in sorted(LAUNCHED["masked_attention_fwd"]):
        if with_lse:
            err, lse_err = check_k1_lse(shape, getattr(torch, dtype), gen, at="path")
            worst["lse"] = max(worst["lse"], lse_err)
        else:
            err = check_k1(shape, getattr(torch, dtype), gen, at="path")
        worst["masked_attention_fwd"] = max(worst["masked_attention_fwd"], err)
    bwd = sorted(LAUNCHED["masked_attention_bwd_dq"] | LAUNCHED["masked_attention_bwd_dkv"])
    for shape, dtype in bwd:
        worst["masked_attention_bwd"] = max(worst["masked_attention_bwd"],
                                            check_bwd_alone(shape, getattr(torch, dtype), gen, at="path"))
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
    phase_kernel_attributes()
    counters = train_counters()

    # main path 1: synthesis (model + server), counts read just after
    synth = production_synthesizer("bfloat16")
    for c in counters.values():
        c.reset()
    phase_model(synth, masked_attention_fwd_count)
    phase_server(synth)
    synthesis = read_counts(counters)
    check(synthesis["masked_attention_fwd"] > 0, "the synthesis path never launched masked_attention_fwd")
    phase_profile(synth)
    del synth
    torch.cuda.empty_cache()
    phase_reference()

    phase_mel_frontend()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # main path 2: training (Trainer over a synthetic corpus), counts read just after
        for c in counters.values():
            c.reset()
        phase_train(tmp)
        training = read_counts(counters)
        for n, count in training.items():
            check(count > 0, f"the training path never launched {n}")
        phase_train_learns(tmp)
        phase_train_reference(tmp)
        phase_train_profile(tmp)

        # the voice-building tools: each phase sets the counts to 0 just
        # before its path and reads them just after
        tools = {"corpus_prep": phase_corpus_prep(tmp, counters)["launches"],
                 "finetune_speaker": phase_finetune_speaker(tmp, counters)["launches"],
                 "style_encoder": phase_style_encoder(tmp, counters)["launches"],
                 "add_speaker": phase_add_speaker(tmp, counters)["launches"],
                 "cli_mcd": phase_cli_mcd(tmp, counters)["launches"]}

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
                     "matcha_tpu/ops/attention.py:117",
                     total["masked_attention_fwd"], max(k1["max_abs_err"], on_path["masked_attention_fwd"]),
                     prod, shape=[16, 5, 512, 64], dtype="bfloat16",
                     lse_max_abs_err=max(k1["lse_max_abs_err"], on_path["lse"]),
                     launches_by_path=by_path["masked_attention_fwd"]),
        kernel_entry("masked_attention_bwd_dq", "masked_attention_bwd.cu",
                     "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
                     total["masked_attention_bwd_dq"], bwd_err,
                     dict(bwd["masked_attention_bwd_dq"], plain_ms=bwd["plain_ms"],
                          library_ms=bwd["library_ms"]),
                     shape=[62, 5, 512, 64], dtype="bfloat16", error="max |err| / max |ref|",
                     plain_and_library="whole backward (dq, dk, dv)",
                     launches_by_path=by_path["masked_attention_bwd_dq"]),
        kernel_entry("masked_attention_bwd_dkv", "masked_attention_bwd.cu",
                     "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
                     total["masked_attention_bwd_dkv"], bwd_err,
                     dict(bwd["masked_attention_bwd_dkv"], plain_ms=bwd["plain_ms"],
                          library_ms=bwd["library_ms"]),
                     shape=[62, 5, 512, 64], dtype="bfloat16", error="max |err| / max |ref|",
                     plain_and_library="whole backward (dq, dk, dv)",
                     launches_by_path=by_path["masked_attention_bwd_dkv"]),
        kernel_entry("mas", "mas.cu", "matcha_tpu/ops/mas_pallas.py:179,189",
                     total["mas"], 0.0, mas_t, shape=[62, 224, 1024], dtype="float32",
                     error="indices equal to the plain version", launches_by_path=by_path["mas"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
