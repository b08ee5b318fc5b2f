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

The launch counters are set to 0 just before each main path (phases 4-5,
synthesis; phase 8, training) and read just after: the kernels line
reports those launches.  The last line is ``{"ok": true, "device": {...}}``.
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


def phase_kernels() -> dict:
    """K1 against its plain version at the paths' shapes (bf16 through the
    wrapper and each layout on its own), its lse against the plain lse with a
    batch row that has no valid key, then timed."""
    import torch.nn.functional as F

    from matcha_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for shape in K1_CHECK_SHAPES:
        b, h, t, d = shape
        valid, lengths = ragged_valid(b, t, gen)
        for dtype in (torch.bfloat16, torch.float32):
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
                  "dtype": str(dtype).split(".")[-1], "key_lengths": lengths.tolist()[:8],
                  "max_abs_err": errs, "tol": TOL[dtype], "ok": ok})
            check(ok, f"masked_attention_fwd disagrees with its plain version at {shape} {dtype}: {errs}")
            worst = max(worst, err)

    worst_lse = 0.0
    for shape in K1_LSE_SHAPES:
        b, h, t, d = shape
        valid, lengths = ragged_valid(b, t, gen, empty_row=True)
        u8 = valid.to(torch.uint8)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
            ref = att.masked_self_attention_plain(q.float(), k.float(), v.float(), valid)
            ref_lse = att.masked_attention_lse_plain(q, k, valid)
            finite, keep = torch.isfinite(ref_lse), ~torch.isnan(ref)
            for layout in ((1, 2) if dtype == torch.bfloat16 else (0,)):
                out, lse = att._launch_fwd(q, k, v, u8, True, layout=layout)
                torch.cuda.synchronize()
                inf_same = bool(torch.equal(torch.isinf(lse), ~finite) and (lse[~finite] > 0).all())
                nan_same = bool(torch.equal(torch.isnan(out), ~keep))
                lse_err = (lse[finite] - ref_lse[finite]).abs().max().item()
                err = (out.float()[keep] - ref[keep]).abs().max().item()
                ok = inf_same and nan_same and lse_err <= LSE_TOL and err <= TOL[dtype]
                emit({"phase": "kernel_check", "kernel": "masked_attention_fwd_lse", "shape": list(shape),
                      "dtype": str(dtype).split(".")[-1], "layout": layout,
                      "key_lengths": lengths.tolist()[:4], "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
                      "empty_row_lse_inf": inf_same, "empty_row_out_nan": nan_same,
                      "max_abs_err": err, "tol": TOL[dtype], "ok": ok})
                check(ok, f"K1's lse or output disagrees at {shape} {dtype} layout {layout}: lse {lse_err}, "
                          f"out {err}, +inf rows {inf_same}, NaN rows {nan_same}")
                worst_lse = max(worst_lse, lse_err)
                worst = max(worst, err)

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
    # every attention call launches the kernel once: the encoder's layers
    # plus the decoder's transformer blocks in each of the 8 U-Net
    # evaluations of midpoint/4 (4 + 8 x 12 = 100 at production widths)
    dec = synth.cfg.decoder
    expected = synth.cfg.encoder.n_layers + 8 * dec.n_blocks * (2 * len(dec.channels) + dec.num_mid_blocks)
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


def phase_training_kernels() -> dict:
    """MAS and K1b against their plain versions on the card, then timed."""
    import numpy as np
    import torch.nn.functional as F

    from matcha_tpu_torch.ops import attention as att
    from matcha_tpu_torch.ops import mas

    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in MAS_SHAPES:
        for kind in ("ragged", "ties"):
            value, x_len, y_len = mas_inputs(shape, gen, kind)
            got = mas.maximum_path_indices_kernel(value, x_len, y_len)
            torch.cuda.synchronize()
            ref = mas.maximum_path_indices_plain(value, x_len, y_len)
            equal = bool(torch.equal(got, ref))
            emit({"phase": "kernel_check", "kernel": "mas", "shape": list(shape), "values": kind,
                  "x_len": x_len.tolist()[:4], "y_len": y_len.tolist()[:4],
                  "indices_equal": equal, "mismatches": int((got != ref).sum())})
            check(equal, f"mas indices differ from the plain version at {shape} ({kind})")
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


def phase_bwd_kernels() -> dict:
    """Each backward kernel alone against ``masked_attention_bwd_plain``, fed
    the log-sum-exp the forward kernel wrote (itself held against
    ``masked_attention_lse_plain``); ragged key lengths including 1.  Keys
    past a row's length must get dk = dv = 0 exactly."""
    from matcha_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in BWD_CHECK_SHAPES:
        b, h, t, d = shape
        lengths = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
        lengths[0], lengths[-1] = 1, t
        valid = (torch.arange(t, device="cuda")[None] < lengths[:, None]).float()
        valid_u8 = valid.to(torch.uint8)
        padded = (valid_u8 == 0)[:, None, :, None].expand(b, h, t, d)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
            out, lse = att._launch_fwd(q, k, v, valid_u8, with_lse=True)
            delta = (dout.float() * out.float()).sum(-1)
            dk, dv = att.masked_attention_bwd_dkv(q, k, v, dout, lse, delta, valid_u8)
            dq = att.masked_attention_bwd_dq(q, k, v, dout, lse, delta, valid_u8)
            torch.cuda.synchronize()
            lse_err = (lse - att.masked_attention_lse_plain(q, k, valid)).abs().max().item()
            ref = att.masked_attention_bwd_plain(q.float(), k.float(), v.float(), dout.float(),
                                                 lse, delta, valid)
            errs = {f"d{n}": rel_err(g, r) for n, g, r in zip("qkv", (dq, dk, dv), ref)}
            pad_zero = bool((dk[padded] == 0).all() and (dv[padded] == 0).all())
            ok = (lse_err <= LSE_TOL and pad_zero
                  and all(math.isfinite(e) and e <= TOL[dtype] for e in errs.values()))
            emit({"phase": "kernel_check", "kernel": "masked_attention_bwd_alone", "shape": list(shape),
                  "dtype": str(dtype).split(".")[-1], "key_lengths": lengths.tolist()[:4],
                  "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL, "rel_err": errs, "tol": TOL[dtype],
                  "padded_keys_zero": pad_zero, "ok": ok})
            check(ok, f"a backward kernel disagrees with masked_attention_bwd_plain at {shape} {dtype}: "
                      f"lse {lse_err}, {errs}, padded keys zero: {pad_zero}")
            worst[dtype] = max(worst[dtype], *errs.values())
            del q, k, v, dout, out, lse, delta, dk, dv, dq, ref
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
        dec = cfg.decoder
        n_attn = dec.n_blocks * (2 * len(dec.channels) + dec.num_mid_blocks)
        want = {"masked_attention_fwd": n_attn, "masked_attention_bwd_dq": n_attn,
                "masked_attention_bwd_dkv": n_attn, "mas": 1}
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
    synthesis = {n: c.launches for n, c in counters.items()}
    check(synthesis["masked_attention_fwd"] > 0, "the synthesis path never launched masked_attention_fwd")
    phase_profile(synth)
    del synth
    torch.cuda.empty_cache()
    phase_reference()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # main path 2: training (Trainer over a synthetic corpus), counts read just after
        for c in counters.values():
            c.reset()
        phase_train(tmp)
        training = {n: c.launches for n, c in counters.items()}
        for n, count in training.items():
            check(count > 0, f"the training path never launched {n}")
        phase_train_learns(tmp)
        phase_train_reference(tmp)
        phase_train_profile(tmp)

    prod = k1["timed"][(16, 5, 512, 64)]
    bwd = kt["timed"][(62, 5, 512, 64)]
    mas_t = kt["timed"][(62, 224, 1024)]
    bwd_err = max(*kt["max_rel_err"].values(), *bwd_alone.values())
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": [
        kernel_entry("masked_attention_fwd", "masked_attention_fwd.cu",
                     "matcha_tpu/ops/attention.py:117",
                     synthesis["masked_attention_fwd"] + training["masked_attention_fwd"],
                     k1["max_abs_err"], prod, shape=[16, 5, 512, 64], dtype="bfloat16",
                     lse_max_abs_err=k1["lse_max_abs_err"],
                     launches_by_path={"synthesis": synthesis["masked_attention_fwd"],
                                       "training": training["masked_attention_fwd"]}),
        kernel_entry("masked_attention_bwd_dq", "masked_attention_bwd.cu",
                     "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
                     training["masked_attention_bwd_dq"], bwd_err,
                     dict(bwd["masked_attention_bwd_dq"], plain_ms=bwd["plain_ms"],
                          library_ms=bwd["library_ms"]),
                     shape=[62, 5, 512, 64], dtype="bfloat16", error="max |err| / max |ref|",
                     plain_and_library="whole backward (dq, dk, dv)"),
        kernel_entry("masked_attention_bwd_dkv", "masked_attention_bwd.cu",
                     "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
                     training["masked_attention_bwd_dkv"], bwd_err,
                     dict(bwd["masked_attention_bwd_dkv"], plain_ms=bwd["plain_ms"],
                          library_ms=bwd["library_ms"]),
                     shape=[62, 5, 512, 64], dtype="bfloat16", error="max |err| / max |ref|",
                     plain_and_library="whole backward (dq, dk, dv)"),
        kernel_entry("mas", "mas.cu", "matcha_tpu/ops/mas_pallas.py:179,189",
                     training["mas"], 0.0, mas_t, shape=[62, 224, 1024], dtype="float32",
                     error="indices equal to the plain version"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
