"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one CUDA card (an H100: the kernels build for sm_90a) and the
``matcha_tpu_torch`` package beside this file.  Exits non-zero, printing no
result, without a card or without the package.  Phases, each printing one
JSON line:

  1. device   card name, count, ``nvidia-smi`` name and power limit
  2. build    compile every hand-written kernel from ops/csrc
  3. kernels  each kernel against its plain PyTorch version on the card
              (max abs error vs the plain version in fp32, within a stated
              tolerance) and timed with CUDA events beside the plain
              version and the library call
  4. model    the full-width model (MatchaConfig + VocosConfig, bf16,
              random weights from a seeded torch.Generator) through the
              synthesizer's entry points: fused B=1 at the production
              bucket (text 256 → fine mel 1024), synthesise_batch at B=16,
              one long request at decoder T=2048
  5. server   the port's HTTP server in-process: /health and three speech
              requests (two concurrent) answered as WAV
  6. profile  one B=1 and one B=16 fused request under torch.profiler:
              device busy time and idle share, the attention kernel's
              share, the kernels that take the most time
  7. reference  at full width in fp32, the kernel path against the plain
              path on a small input

The launch counters are set to 0 just before phase 4 and read after phase
5: the kernels line reports those launches.  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import wave

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


def attention_bound_ms(b, h, t, d, dtype, n_valid_keys) -> tuple[float, str]:
    """Least time for one call: q, k, v read once, out written once, the
    (B, T) mask read once; 4·B·H·T·(valid keys)·D flops at the dtype's peak."""
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * h * t * d * elem + b * t
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


def phase_kernels() -> dict:
    """K1 against its plain version at the path's shapes, then timed."""
    import torch.nn.functional as F

    from matcha_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    shapes = [(16, 6, 256, 48), (16, 5, 512, 64), (16, 5, 256, 64), (2, 6, 4000, 48), (3, 5, 333, 64)]
    for shape in shapes:
        b, h, t, d = shape
        lengths = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
        lengths[0], lengths[-1] = 1, t
        valid = (torch.arange(t, device="cuda")[None] < lengths[:, None]).float()
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
            out = att.masked_attention_fwd(q, k, v, valid)
            torch.cuda.synchronize()
            ref = att.masked_self_attention_plain(q.float(), k.float(), v.float(), valid)
            err = (out.float() - ref).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and err <= TOL[dtype]
            emit({"phase": "kernel_check", "kernel": "masked_attention_fwd", "shape": list(shape),
                  "dtype": str(dtype).split(".")[-1], "key_lengths": lengths.tolist(),
                  "max_abs_err": err, "tol": TOL[dtype], "ok": ok})
            check(ok, f"masked_attention_fwd disagrees with its plain version at {shape} {dtype}: {err}")
            worst = max(worst, err)

    timed = {}
    for shape in [(16, 6, 256, 48), (16, 5, 512, 64), (16, 5, 256, 64)]:
        b, h, t, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16) for _ in range(3))
        valid = torch.ones((b, t), device="cuda")
        keep = valid[:, None, None, :] > 0
        ms = cuda_ms(lambda: att.masked_attention_fwd(q, k, v, valid))
        plain_ms = cuda_ms(lambda: att.masked_self_attention_plain(q, k, v, valid))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep))
        bound_ms, bound_by = attention_bound_ms(b, h, t, d, torch.bfloat16, t)
        timed[shape] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        emit({"phase": "kernel_time", "kernel": "masked_attention_fwd", "shape": list(shape),
              "dtype": "bfloat16", **timed[shape]})
    return {"max_abs_err": worst, "timed": timed}


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


def device_breakdown(run) -> dict:
    """One ``run()`` under torch.profiler: the device's busy time (union of
    kernel and copy intervals), the attention kernel's share of it, and the
    kernels that take the most time.  Host wall time is taken with the
    profiler off, around the same call ending in a synchronize."""
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
    return {"wall_ms": wall_ms, "device_events": len(spans), "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if spans else None,
            "attention_ms": attention_us / 1e3, "attention_launches": attention_n,
            "attention_share_of_busy": attention_us / busy_us if busy_us else None,
            "top_kernels_ms": [[n[:90], t / 1e3] for n, t in top]}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from matcha_tpu_torch.ops.attention import masked_attention_fwd_count

    dev = phase_device()
    phase_build()
    k1 = phase_kernels()

    synth = production_synthesizer("bfloat16")
    masked_attention_fwd_count.reset()
    phase_model(synth, masked_attention_fwd_count)
    phase_server(synth)
    launches = masked_attention_fwd_count.launches
    check(launches > 0, "the main path never launched masked_attention_fwd")
    phase_profile(synth)
    del synth
    torch.cuda.empty_cache()

    phase_reference()

    prod = k1["timed"][(16, 5, 512, 64)]
    print(dev["nvidia_smi"], flush=True)
    emit({"kernels": [{
        "name": "masked_attention_fwd", "route": "cuda",
        "source": "matcha_tpu_torch/ops/csrc/masked_attention_fwd.cu",
        "replaces": "matcha_tpu/ops/attention.py:117",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": prod["ms"], "plain_ms": prod["plain_ms"], "bound_ms": prod["bound_ms"],
        "bound_by": prod["bound_by"], "library_ms": prod["library_ms"],
        "shape": [16, 5, 512, 64], "dtype": "bfloat16",
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
