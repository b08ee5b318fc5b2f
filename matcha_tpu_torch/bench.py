"""Headline benchmark of the port: batched 24 kHz text→wav synthesis RTF on
one card.

The port's counterpart of ``bench.py`` (the JAX system's benchmark),
function for function, at its operating point: bf16, text bucket 256 →
fine mel bucket 1024 (decoder T = 512), midpoint/4 (8 U-Net evaluations),
random weights from seeded generators.  The headline is the fused path
(``_Replica.synth_fused`` as the server's batcher runs it: host inputs in,
the totals and the whole waveform back in one device→host copy) at B=16:

    RTF = wall time of one call / seconds of audio it makes   (lower is better)

It also times both two-stage programs at the same point (``measure``:
stage A, the encoder and duration predictor; stage B, alignment → CFM ODE
→ Vocos) and the B=1 latency of both paths, and on the card:

  * ``mfu``: the analytic FLOP count (``utils/flops.py``, FlopCounterMode's
    convention: matmul, conv and attention products) over the headline's
    wall time over the H100 SXM's dense bf16 peak, 989 TFLOP/s
  * ``device_probe``: each stage's device time as one CUDA-graph replay of
    a chain of calls (``utils/probe.inner_repeat``)
  * ``device_breakdown``: a ``torch.profiler`` trace of each stage's loop
    and of the fused B=1 and B=16 calls, one trace each, read by
    ``utils/trace_analysis.device_stats``: device busy time, device events
    and idle share a call (wall time taken with the profiler off), the
    audio's device→host copy apart (``d2h_copy_ms``)
  * ``BENCH_SCALING=1``: the two-stage RTF at B=1/8/16/32

Three rules.  The work is real: the duration head is pinned at 4 fine
frames a token, so 256 tokens fill the 1024 bucket with speech.  No number
without parity: before it times anything it runs the hardware parity
tier's readings (``utils/hw_parity``) in the same process, prints them on
a line of their own, and exits 1, printing no headline, when a bar is
missed.  No fallback: any failure propagates and the run exits non-zero.

    python -m matcha_tpu_torch.bench [--iters 10]

prints the parity line, then ONE JSON line with ``bench.py``'s keys and the
port's own (``device``, ``spread_ms``, ``device_idle_share``,
``device_events_per_call``, ``device_probe``).  Every wall metric is a
median over repeats in one process (10 calls at B=16, 20 at B=1), with
its spread (min, max, n).

``--device cpu`` (with ``--tiny``: tiny widths, text 16 → fine 64) runs the
harness on the CPU, for its tests only: the device-only fields are null
and listed under ``not_measured``, and the metric is named as a CPU run.
Without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

H100_PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
TX, Y_FINE_LEN = 256, 1024     # production bucket: 5.44 s of audio a row
TINY_TX, TINY_Y_FINE_LEN = 16, 64
ITERS = 10
B1_ITERS = 20      # B=1 calls timed per path: host times spread widely
TRACE_ITERS = 5    # calls in each traced loop
TARGET_RTF = 0.01  # BASELINE.json's north star: RTF < 0.01 per chip
N_TIMESTEPS, SOLVER = 4, "midpoint"
FRAMES_PER_TOKEN = 4  # the pinned duration head (fine frames a token)
DURATIONS = f"pinned {FRAMES_PER_TOKEN} fine frames/token"
DEVICE_FIELDS = ("mfu", "device_probe", "device_breakdown", "device_idle_share", "device_events_per_call")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ms(seconds: float) -> float:
    return round(seconds * 1e3, 3)


def spread(times: list[float]) -> dict:
    """min, max and count of wall times in seconds, as ms."""
    return {"min": _ms(min(times)), "max": _ms(max(times)), "n": len(times)}


def pin_durations(params: dict) -> dict:
    """The duration head set to log(2 + 4): every token lasts 4 fine
    frames (random log-durations collapse to the 1-frame floor)."""
    params["encoder.proj_w.proj.weight"].zero_()
    params["encoder.proj_w.proj.bias"].fill_(math.log(2.0 + FRAMES_PER_TOKEN))
    return params


def configs(compute_dtype: str = "bfloat16", tiny: bool = False):
    """(MatchaConfig, VocosConfig) at full width, or tiny for the harness."""
    from matcha_tpu_torch.models.config import MatchaConfig, tiny_config
    from matcha_tpu_torch.vocoder.vocos import VocosConfig

    if tiny:
        cfg = tiny_config()
        vcfg = VocosConfig(input_channels=cfg.n_feats, dim=32, intermediate_dim=64, num_layers=1)
    else:
        cfg, vcfg = MatchaConfig(), VocosConfig()
    return (dataclasses.replace(cfg, compute_dtype=compute_dtype),
            dataclasses.replace(vcfg, compute_dtype=compute_dtype))


def build_synthesizer(cfg, vcfg, device, tiny: bool = False):
    """The synthesizer with random weights (torch.Generator seeds 0 and 1,
    as bench.py's PRNGKeys) and the pinned duration head."""
    from matcha_tpu_torch.inference import MatchaSynthesizer
    from matcha_tpu_torch.models.matcha import init_params
    from matcha_tpu_torch.vocoder.vocos import init_vocos_params

    params = pin_durations(init_params(cfg, torch.Generator().manual_seed(0)))
    vparams = init_vocos_params(vcfg, torch.Generator().manual_seed(1))
    buckets = dict(text_buckets=(16, 32, 64), mel_fine_buckets=(64, 128, 256)) if tiny else {}
    return MatchaSynthesizer(cfg, params, vparams, vcfg, device=device, **buckets)


def _ids(seed: int, batch: int, tx: int, n: int) -> list[np.ndarray]:
    """bench.py's ids: ``n`` draws of ``default_rng(seed).integers(0, 600, (B, tx))``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 600, (batch, tx)) for _ in range(n)]


def _stage_a_host(cfg, batch: int, tx: int):
    """x_lengths, speaker rows (zeros) and scales (ones) as bench.py's."""
    return (torch.full((batch,), tx, dtype=torch.int64),
            torch.zeros((batch, cfg.spk_emb_dim), dtype=torch.float32),
            torch.zeros((batch, cfg.spk_emb_dim), dtype=torch.float32),
            torch.ones((batch, 1), dtype=torch.float32))


def audio_seconds(batch: int, y_fine_len: int) -> float:
    return batch * (y_fine_len // 2 - 1) * 256 / 24000


def _check_finite(checksum: float, what: str) -> None:
    if not math.isfinite(checksum):
        raise RuntimeError(f"{what}: non-finite output")


def measure(synth, cfg, batch, iters=ITERS, seed=0, tx=TX, y_fine_len=Y_FINE_LEN):
    """Median per-stage wall time for one (batch, tx, y_fine_len) point, each
    call ending in a device→host copy of a scalar of its output.

    Returns encoder/decode ms, rtf, audio seconds, each stage's spread,
    ``_rerun`` (one iteration of each stage's loop, for the traces) and
    ``_inputs`` (the warm inputs, for the probe)."""
    rep = synth.replicas[0]
    dev = rep.device
    x_all = [torch.from_numpy(x).to(dev) for x in _ids(seed, batch, tx, iters + 1)]
    x_lengths, spk_enc, spk_dur, scale = (t.to(dev) for t in _stage_a_host(cfg, batch, tx))

    def run_a(x):
        return rep.encode(x, x_lengths, spk_enc, spk_dur, scale)

    mu_x, durations, x_mask = run_a(x_all[-1])  # warm-up
    totals = torch.clamp(durations.sum(dim=1).to(torch.int64), 2, y_fine_len)

    def run_b(mu):
        _, wav, _ = rep.decode(mu, durations, x_mask, totals, y_fine_len=y_fine_len,
                               n_timesteps=N_TIMESTEPS, solver=SOLVER)
        return wav

    def one_a(i):
        _, dur_i, _ = run_a(x_all[i])
        return float(dur_i[:, :8].sum())  # forces the call and a D2H copy

    def one_b(i):
        # the input varies per iteration, as in bench.py
        return float(run_b(mu_x + 1e-6 * i)[:, :8].sum())

    def timed(one):
        one(0)  # warm-up
        checksum, times = 0.0, []
        for i in range(iters):
            t0 = time.perf_counter()
            checksum += one(i)
            times.append(time.perf_counter() - t0)
        return checksum, times

    sum_a, times_a = timed(one_a)
    sum_b, times_b = timed(one_b)
    _check_finite(sum_a + sum_b, f"two-stage B={batch}")
    elapsed_a, elapsed_b = statistics.median(times_a), statistics.median(times_b)
    seconds = audio_seconds(batch, y_fine_len)
    return {
        "batch": batch,
        "encoder_ms": _ms(elapsed_a),
        "decode_vocoder_ms": _ms(elapsed_b),
        "total_ms": _ms(elapsed_a + elapsed_b),
        "audio_seconds": round(seconds, 2),
        "rtf": (elapsed_a + elapsed_b) / seconds,
        "spread_ms": {"encoder_ms": spread(times_a), "decode_vocoder_ms": spread(times_b)},
        "_rerun": {"encode": one_a, "decode": one_b, "x_all": x_all, "device": dev},
        "_inputs": {"x": x_all[0], "x_lengths": x_lengths, "spk_enc": spk_enc, "spk_dur": spk_dur,
                    "scale": scale, "mu_x": mu_x, "durations": durations, "x_mask": x_mask,
                    "totals": totals, "y_fine_len": y_fine_len},
    }


def fused_call(synth, host_args, y_fine_len: int):
    """One fused call as the serving batcher makes it
    (``MatchaSynthesizer._run_fused``): host tensors in, (totals, waveform)
    back as numpy, pulled in one device→host copy."""
    return synth._run_fused(host_args, y_fine_len=y_fine_len, n_timesteps=N_TIMESTEPS, solver=SOLVER)


def measure_fused(synth, cfg, batch=1, iters=ITERS, seed=2, tx=TX, y_fine_len=None):
    """Median wall time of the fused path as the serving batcher runs it
    (``fused_call``: host inputs in, ``_Replica.synth_fused``, the totals
    and the whole waveform back in one device→host copy).
    ``y_fine_len=None`` uses the synthesizer's own bucket prediction for
    ``tx``; pass a bucket to pin the audio accounting to a two-stage point."""
    x_all = [torch.from_numpy(x) for x in _ids(seed, batch, tx, iters + 1)]
    rest = _stage_a_host(cfg, batch, tx)
    if y_fine_len is None:
        y_fine_len = synth.predict_fine_bucket(tx)

    def one(i):
        totals, wav = fused_call(synth, (x_all[i], *rest), y_fine_len)
        return float(wav[:, :8].sum()) + int(totals[0])

    one(iters)  # warm-up
    checksum, times = 0.0, []
    for i in range(iters):
        t0 = time.perf_counter()
        checksum += one(i)
        times.append(time.perf_counter() - t0)
    _check_finite(checksum, f"fused B={batch}")
    elapsed = statistics.median(times)
    return {
        "batch": batch,
        "total_ms": _ms(elapsed),
        "rtf": elapsed / audio_seconds(batch, y_fine_len),
        "y_fine_len": y_fine_len,
        "spread_ms": {"total_ms": spread(times)},
        "_rerun": {"fused": one, "device": synth.device},
    }


def device_probe(synth, point, k=4, reps=5):
    """Each stage's device time from ``utils/probe.inner_repeat``: on the
    card the chain of ``k`` calls is captured as one CUDA graph and timed
    as one replay against the chain of one, so fixed costs cancel:

        device_ms ~= (wall_k - wall_1) / (k - 1),  fixed_ms ~= wall_1 - device_ms

    Each body sums every output of its stage in full (the probe's honesty
    rule).  A stage that cannot be captured raises."""
    from matcha_tpu_torch.utils.probe import inner_repeat

    rep = synth.replicas[0]
    i = point["_inputs"]

    def body_a(acc, x, x_lengths, spk_enc, spk_dur, scale):
        mu, dur, x_mask = rep.encode(x, x_lengths, spk_enc + acc, spk_dur, scale)
        return (mu.float().sum() + dur.sum() + x_mask.sum()) * 1e-12

    def body_b(acc, mu_x, durations, x_mask, totals):
        mel, wav, enc_mel = rep.decode(mu_x + acc, durations, x_mask, totals, y_fine_len=i["y_fine_len"],
                                       n_timesteps=N_TIMESTEPS, solver=SOLVER)
        return (mel.float().sum() + wav.float().sum() + enc_mel.float().sum()) * 1e-12

    out = {}
    for name, fn, args in (
        ("encode", body_a, (i["x"], i["x_lengths"], i["spk_enc"], i["spk_dur"], i["scale"])),
        ("decode", body_b, (i["mu_x"], i["durations"], i["x_mask"], i["totals"])),
    ):
        r = inner_repeat(fn, *args, k=k, reps=reps)
        out[f"device_{name}_ms"] = round(r["device_ms"], 3)
        out[f"fixed_overhead_{name}_ms"] = round(r["fixed_ms"], 3)
    out["method"] = f"inner-repeat k={k}: one CUDA-graph replay of the k-call chain, (wall_k - wall_1)/(k - 1)"
    return out


def _traced(one, device: torch.device, iters: int) -> dict:
    """``one(i)`` for i < iters, first with the profiler off (wall time),
    then under ``utils/profiling.trace``: device busy time, device events,
    idle share and the device→host copies, each per call."""
    from matcha_tpu_torch.utils import profiling, trace_analysis

    _sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        one(i)
    _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as logdir:
        with profiling.trace(logdir):
            for i in range(iters):
                one(i)
        stats = trace_analysis.device_stats(logdir)
    if not stats["device_events"]:
        raise RuntimeError(f"no device event in the trace (planes {stats['device_planes']})")
    busy = stats["device_busy_ms"] / iters
    d2h = sum(m["ms"] for n, m in stats["modules"].items() if "Memcpy DtoH" in n) / iters
    return {"wall_ms": round(wall_ms, 3), "device_busy_ms": round(busy, 3),
            "device_events": stats["device_events"] / iters, "idle_share": 1.0 - busy / wall_ms,
            "d2h_copy_ms": round(d2h, 3)}


def device_breakdown(point, fused_points: dict, iters=TRACE_ITERS):
    """One ``torch.profiler`` trace of each stage's loop (``point``, the
    two-stage B=16 run) and of each fused point's, read by
    ``utils/trace_analysis.device_stats``: one trace per loop, so no kernel
    name decides what belongs to a stage.  Times are per call."""
    rerun = point["_rerun"]
    enc = _traced(rerun["encode"], rerun["device"], iters)
    dec = _traced(rerun["decode"], rerun["device"], iters)
    fused = {name: _traced(p["_rerun"]["fused"], p["_rerun"]["device"], iters) for name, p in fused_points.items()}
    return {
        "device_encode_ms": enc["device_busy_ms"], "device_decode_ms": dec["device_busy_ms"],
        "wall_encode_ms": enc["wall_ms"], "wall_decode_ms": dec["wall_ms"],
        "idle_share_encode": enc["idle_share"], "idle_share_decode": dec["idle_share"],
        "device_events_encode": enc["device_events"], "device_events_decode": dec["device_events"],
        **fused,
        # the B=16 waveform's device→host copy (pageable), apart from the
        # compute: its time follows the host's pages as much as the card
        "d2h_copy_ms": fused["fused_b16"]["d2h_copy_ms"] if "fused_b16" in fused else None,
        "trace_iters": iters,
        "method": "torch.profiler trace per loop (utils/trace_analysis.device_stats); wall with the profiler off",
    }


def pick_headline(two_stage_rtf, two_stage_flops, two_stage_ms, fused16, peak_flops=H100_PEAK_BF16_FLOPS):
    """bench.py's rule: the fused B=16 point when it measured (a dict with
    an ``rtf``), else the two-stage point.  Returns (rtf, path label, mfu,
    mfu_flops_source); the FLOP count is the analytic one of the measured
    work (``utils/flops.py``), the same for both paths.  Pops ``flops``
    from ``fused16``."""
    if isinstance(fused16, dict) and "rtf" in fused16:
        rtf, path = fused16["rtf"], "fused_single_dispatch_b16"
        mfu_flops = fused16.pop("flops", 0.0) or two_stage_flops
        mfu_ms = fused16["total_ms"]
    else:
        rtf, path = two_stage_rtf, "two_stage_b16"
        mfu_flops, mfu_ms = two_stage_flops, two_stage_ms
    mfu = mfu_flops / (mfu_ms / 1e3) / peak_flops if mfu_flops else None
    return rtf, path, mfu, "analytic"


def device_info(device: torch.device) -> dict:
    """The device the run measured: the card's name, count and
    ``nvidia-smi`` name and power limit, or the CPU."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "count": 0, "nvidia_smi": None}
    from matcha_tpu_torch.utils.hw_gate import card

    info = card()
    return {"platform": "gpu", "name": info["name"], "count": info["count"], "nvidia_smi": info["nvidia_smi"],
            "torch": info["torch"], "cuda": info["cuda"]}


def parity(device) -> tuple[dict, list[str]]:
    """The hardware parity tier's readings on ``device`` and the bars they
    miss (``utils/hw_parity``)."""
    from matcha_tpu_torch.utils import hw_parity

    readings = hw_parity.parity_readings(device)
    return readings, hw_parity.bar_misses(readings)


def _public(point: dict) -> dict:
    return {k: v for k, v in point.items() if not k.startswith("_")}


def main(argv=None) -> int:
    from matcha_tpu_torch.inference import resolve_device
    from matcha_tpu_torch.utils.flops import synthesis_flops

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' for the harness)")
    ap.add_argument("--tiny", action="store_true", help="tiny widths (text 16 -> fine 64), for the harness")
    ap.add_argument("--iters", type=int, default=ITERS, help="timed calls at B=16")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises without a card
    on_card = device.type == "cuda"

    readings, misses = parity(device)
    print(json.dumps({"parity": readings, "bar_misses": misses}), flush=True)
    if misses:
        print(f"bench: hardware parity bars missed, no number reported: {misses}", file=sys.stderr)
        return 1

    cfg, vcfg = configs("bfloat16", args.tiny)
    tx, fine = (TINY_TX, TINY_Y_FINE_LEN) if args.tiny else (TX, Y_FINE_LEN)
    synth = build_synthesizer(cfg, vcfg, device, args.tiny)
    flops16 = synthesis_flops(cfg, vcfg, 16, tx, fine, N_TIMESTEPS, SOLVER)

    # two-stage B=16: the per-stage decomposition and the probe's point
    head = measure(synth, cfg, 16, args.iters, seed=0, tx=tx, y_fine_len=fine)
    # headline: the same point through the fused path, at the same bucket
    fused16 = measure_fused(synth, cfg, 16, args.iters, seed=3, tx=tx, y_fine_len=fine)
    fused16["flops"] = flops16
    rtf, headline_path, mfu, mfu_src = pick_headline(head["rtf"], flops16, head["total_ms"], fused16)
    # one request, both paths (the fused one at the synthesizer's predicted bucket)
    lat = measure(synth, cfg, 1, B1_ITERS, seed=1, tx=tx, y_fine_len=fine)
    fused = measure_fused(synth, cfg, 1, B1_ITERS, seed=2, tx=tx)

    probe = breakdown = None
    if on_card:
        probe = device_probe(synth, head)
        breakdown = device_breakdown(head, {"fused_b1": fused, "fused_b16": fused16})
    else:
        mfu = None  # a CPU time is not a device metric

    scaling = None
    if os.environ.get("BENCH_SCALING") == "1":
        scaling = {}
        for b in (1, 8, 16, 32):
            p = head if b == 16 else lat if b == 1 else measure(synth, cfg, b, args.iters, seed=b, tx=tx,
                                                                y_fine_len=fine)
            scaling[str(b)] = {"rtf": round(p["rtf"], 6), "total_ms": p["total_ms"]}

    fused_b1_flops = synthesis_flops(cfg, vcfg, 1, tx, fused["y_fine_len"], N_TIMESTEPS, SOLVER)
    result = {
        "metric": "batched_synthesis_rtf_per_chip" if on_card else "batched_synthesis_rtf_cpu_harness",
        "value": round(rtf, 6),
        "unit": "rtf",
        "vs_baseline": round(rtf / TARGET_RTF, 4),
        "headline_path": headline_path,
        "mfu": mfu,
        "mfu_flops_source": mfu_src,
        "mfu_peak_flops": H100_PEAK_BF16_FLOPS,
        "latency_p50_b1_ms": lat["total_ms"],
        "latency_p50_b1_fused_ms": fused["total_ms"],
        "fused_b16": _public(fused16),
        "two_stage_b16_rtf": round(head["rtf"], 6),
        "stage_breakdown": {**{k: v for k, v in _public(head).items() if k != "rtf"},
                            "tflops_per_call": round(flops16 / 1e12, 6)},
        "device_probe": probe,
        "device_breakdown": breakdown,
        "fused_b1": {**_public(fused), "tflops_per_call": round(fused_b1_flops / 1e12, 6)},
        "spread_ms": {"latency_b1": lat["spread_ms"], "latency_b1_fused": fused["spread_ms"]["total_ms"],
                      "fused_b16": fused16["spread_ms"]["total_ms"], "two_stage_b16": head["spread_ms"]},
        "device_idle_share": None if breakdown is None else {
            "b1_fused": breakdown["fused_b1"]["idle_share"], "b16_fused": breakdown["fused_b16"]["idle_share"]},
        "device_events_per_call": None if breakdown is None else {
            "b1_fused": breakdown["fused_b1"]["device_events"], "b16_fused": breakdown["fused_b16"]["device_events"]},
        "device": device_info(device),
        "compute_dtype": cfg.compute_dtype,
        "operating_point": {"tx": tx, "y_fine_len": fine, "n_timesteps": N_TIMESTEPS, "solver": SOLVER,
                            "widths": "tiny" if args.tiny else "MatchaConfig() + VocosConfig()"},
        "durations": DURATIONS,
        "weights": "random (torch.Generator seeds 0 and 1)",
        "parity": {"fp32_mcd_db": readings["fp32_vs_fp32_oracle"]["mel_mcd_db"],
                   "bf16_mcd_db": readings["bf16_vs_fp32_oracle"]["mel_mcd_db"],
                   "fused_mcd_db": readings["fused_vs_two_stage_mcd_db"], "bar_misses": misses},
    }
    if not on_card:
        result["not_measured"] = list(DEVICE_FIELDS)
    if scaling is not None:
        result["batch_scaling"] = scaling
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
