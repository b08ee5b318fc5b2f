"""Measured A/B of the stage-B device-time levers on the card.

The port's counterpart of ``tools/ab_stage_b_levers.py``, at the
benchmark's operating point (B=16, text 256, fine mel 1024, bf16) with
``utils/probe.inner_repeat`` (one CUDA-graph replay of a chain of calls):

  (a) ``DecoderConfig.bf16_norm_stats``: the decoder's GroupNorm/LayerNorm
      statistics in the compute dtype instead of fp32.  Stage B's device
      ms with and without, and the mel cost (MCD against the fp32-stats
      baseline), so the quality gate is part of the decision.
  (b) the conv layout.  Every port ``Conv1d`` runs on time-major (B, T, C)
      input and transposes to (B, C, T) around ``F.conv1d`` and back
      (``models/layers.py``): "nwc", as the model runs it, with its fp32
      weight cast to bf16 on every call, and "nwc_bf16_weight", the same
      module with the weight already bf16 (the transposes alone).  "ncw"
      is ``F.conv1d`` on a contiguous (B, C, T) tensor with a bf16 weight
      and no transposes, the layout kept channel-first through a block.
      Each beside its bound, max(FLOPs / 989 TF/s, bytes / 3.35 TB/s),
      and the two layouts' outputs compared.  The stride-2 case pads
      (1, 1) as the decoder's ``Downsample1D`` does; the JAX tool's
      ``down_conv3_s2`` case pads "SAME", that is (0, 1).
  (c) ``fp32_residual`` on the encoder and decoder together: what the
      fp32 carry costs in device ms, and the mel gap without it.

Each lever builds its own synthesizers (``bench.build_synthesizer``:
random weights from seeds 0 and 1, duration head pinned at 4 fine frames
a token) and frees each before the next.

    python -m matcha_tpu_torch.utils.ab_stage_b_levers [--device cpu --tiny]

prints one JSON report (the JAX tool's keys, plus ``device`` with the
card's ``nvidia-smi`` name and power limit, and ``durations``) and exits
non-zero on any failure.  Accept rule, as the JAX tool's: a lever ships
only if device ms improves beyond the probe's noise and, for (a) and (c),
the parity tier stays under its bars with it.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import json
import math
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from matcha_tpu_torch.utils.ab_fast_solvers import (
    B,
    TINY_B,
    TINY_TX,
    TINY_Y_FINE_LEN,
    TX,
    Y_FINE_LEN,
    decode_mel,
    probe_decode,
    stage_b_inputs,
    timing_fields,
)

PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# (name, T, Cin, Cout, kernel, stride) at the decoder's shapes, batch B
CONV_CASES = (
    ("body_conv3_c320_t512", 512, 320, 320, 3, 1),
    ("body_conv3_c320_t256", 256, 320, 320, 3, 1),
    ("down_conv3_s2_c320_t512", 512, 320, 320, 3, 2),
    ("wide_conv3_c640_t256", 256, 640, 640, 3, 1),
)
DOWN_PADDING = ("pads (1, 1) as the decoder's Downsample1D; the JAX tool's down_conv3_s2 case pads "
                "'SAME', that is (0, 1)")


def lever_config(cfg, bf16_norm_stats: bool = False, fp32_residual: bool = True):
    """``cfg`` with the decoder's norm-statistics switch and the fp32 carry
    of the encoder and the decoder set, as the JAX tool's ``build_synth``."""
    return dataclasses.replace(
        cfg,
        decoder=dataclasses.replace(cfg.decoder, bf16_norm_stats=bf16_norm_stats, fp32_residual=fp32_residual),
        encoder=dataclasses.replace(cfg.encoder, fp32_residual=fp32_residual),
    )


def build_synth(device, bf16_norm_stats: bool = False, fp32_residual: bool = True, tiny: bool = False):
    """The benchmark's synthesizer (bf16) with the two switches set; the
    weights do not depend on them."""
    from matcha_tpu_torch import bench

    cfg, vcfg = bench.configs("bfloat16", tiny)
    return bench.build_synthesizer(lever_config(cfg, bf16_norm_stats, fp32_residual), vcfg, device, tiny)


def free(synth) -> None:
    """Drop a synthesizer and give its memory back before the next one."""
    device = synth.device
    del synth
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _pair(build, switches: dict, point: tuple[int, int, int], k: int, reps: int):
    """Baseline's and variant's timing fields and the MCD between their
    mels.  The variant decodes the baseline's stage-A outputs, as the JAX
    tool does."""
    from matcha_tpu_torch.utils.hw_parity import mel_mcd_db

    b, tx, fine = point
    out, inputs = {}, None
    for name, kw in switches.items():
        synth = build(**kw)
        with torch.inference_mode():
            if inputs is None:
                inputs = stage_b_inputs(synth, b, tx, fine)
            mel = decode_mel(synth, inputs, "midpoint", 4, fine)  # warm-up and quality reference
            probe = probe_decode(synth, inputs, "midpoint", 4, fine, k, reps)
        on_card = synth.device.type == "cuda"
        free(synth)
        out[name] = (mel, timing_fields(probe, on_card))
    (mel_a, t_a), (mel_b, t_b) = out.values()
    return t_a, t_b, round(mel_mcd_db(mel_a, mel_b), 4)


def _delta(t_a: dict, t_b: dict):
    key = "device_ms" if t_a["device_ms"] is not None else "cpu_ms"
    return round(t_b[key] - t_a[key], 3), key


def lever_a(build, point=(B, TX, Y_FINE_LEN), k: int = 4, reps: int = 5) -> dict:
    """bf16 norm statistics: device time and mel cost against the fp32-stats default."""
    base, var, mcd = _pair(build, {"baseline": {}, "bf16_stats": {"bf16_norm_stats": True}}, point, k, reps)
    delta, key = _delta(base, var)
    out = {"baseline_device_ms": base["device_ms"], "bf16_stats_device_ms": var["device_ms"],
           "delta_ms": delta, "mel_mcd_vs_baseline_db": mcd}
    if key == "cpu_ms":
        out.update(baseline_cpu_ms=base["cpu_ms"], bf16_stats_cpu_ms=var["cpu_ms"])
    return out


def lever_c(build, point=(B, TX, Y_FINE_LEN), k: int = 4, reps: int = 5) -> dict:
    """What the fp32 carry costs: stage B with fp32_residual on (the
    default) against the all-bf16 carry, and the mel gap between them."""
    on, off, mcd = _pair(build, {"fp32_carry": {"fp32_residual": True}, "bf16_carry": {"fp32_residual": False}},
                         point, k, reps)
    delta, key = _delta(off, on)
    out = {"fp32_carry_device_ms": on["device_ms"], "bf16_carry_device_ms": off["device_ms"],
           "delta_ms": delta, "mel_mcd_carry_gap_db": mcd}
    if key == "cpu_ms":
        out.update(fp32_carry_cpu_ms=on["cpu_ms"], bf16_carry_cpu_ms=off["cpu_ms"])
    return out


# -- (b) the conv layout --------------------------------------------------------

def conv_case(b: int, t: int, cin: int, cout: int, kernel: int, stride: int, dtype=torch.bfloat16,
              device="cpu", seed: int = 1):
    """One decoder conv in both layouts on the same numbers.

    Returns (x_nwc, conv, x_ncw, ncw): ``conv`` is the port's
    ``layers.Conv1d`` (fp32 weight and bias, computed in ``dtype``), whose
    forward takes (B, T, C); ``ncw(x)`` is ``F.conv1d`` on a
    contiguous (B, C, T) ``x`` with the weight and bias already in
    ``dtype``.  Padding 1 at both strides, as the decoder's body convs and
    ``Downsample1D``."""
    from matcha_tpu_torch.models.layers import Conv1d

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, t, cin)).astype(np.float32)).to(device, dtype)
    conv = Conv1d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, dtype=dtype)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.standard_normal((cout, cin, kernel)).astype(np.float32) * 0.02))
        conv.bias.copy_(torch.from_numpy(rng.standard_normal(cout).astype(np.float32) * 0.02))
    conv = conv.to(device)
    w, bias = conv.weight.detach().to(dtype), conv.bias.detach().to(dtype)
    x_ncw = x.transpose(1, 2).contiguous()

    def ncw(xx):
        return F.conv1d(xx, w, bias, stride, conv.padding)

    return x, conv, x_ncw, ncw


def conv_bound(b, t, cin, cout, kernel, stride) -> tuple[float, str]:
    """Least time in ms of one bf16 conv: input, weight and bias read once,
    output written once; 2·B·T_out·Cout·Cin·K flops at the bf16 peak."""
    from matcha_tpu_torch.bench import H100_PEAK_BF16_FLOPS

    t_out = (t + 2 * ((kernel - 1) // 2) - kernel) // stride + 1
    nbytes = (b * t * cin + cout * cin * kernel + cout + b * t_out * cout) * 2
    flops = 2 * b * t_out * cout * cin * kernel
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / H100_PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def layout_rel_diff(nwc_out: torch.Tensor, ncw_out: torch.Tensor) -> float:
    """max |nwc − ncw| / max |ncw|, both as (B, C, T) float32."""
    a, ref = nwc_out.transpose(1, 2).float(), ncw_out.float()
    return float((a - ref).abs().max() / ref.abs().max())


def _conv_probe(fn, x, k: int = 8, reps: int = 5) -> dict:
    """One conv call's time from an amplified inner-repeat chain."""
    from matcha_tpu_torch.utils.probe import inner_repeat

    def body(acc, xx):
        return fn(xx + acc.to(xx.dtype)).float().sum() * 1e-12

    return inner_repeat(body, x, k=k, reps=reps)


def lever_b(device, b: int = B, cases=CONV_CASES, k: int = 8, reps: int = 5) -> dict:
    """The decoder's convs in both layouts, bf16: each time beside its bound."""
    on_card = torch.device(device).type == "cuda"
    out = {}
    for name, t, cin, cout, kernel, stride in cases:
        x, nwc, x_ncw, ncw = conv_case(b, t, cin, cout, kernel, stride, device=device)
        bf16_weight = copy.deepcopy(nwc).to(torch.bfloat16)  # its per-call casts are no-ops
        bound, bound_by = conv_bound(b, t, cin, cout, kernel, stride)
        with torch.no_grad():
            rel = layout_rel_diff(nwc(x), ncw(x_ncw))
            times = {"nwc": _conv_probe(nwc, x, k, reps), "nwc_bf16_weight": _conv_probe(bf16_weight, x, k, reps),
                     "ncw": _conv_probe(ncw, x_ncw, k, reps)}
        unit = "ms" if on_card else "cpu_ms"
        entry = {f"{n}_{unit}": r["device_ms"] for n, r in times.items()}
        entry.update(bound_ms=bound, bound_by=bound_by, shape={"B": b, "T": t, "Cin": cin, "Cout": cout,
                                                               "kernel": kernel, "stride": stride, "padding": 1},
                     ncw_vs_nwc_max_rel_diff=rel)
        if stride > 1:
            entry["padding_note"] = DOWN_PADDING
        out[name] = entry
        print(f"[ab-levers] {name}: {entry}", file=sys.stderr)
    return out


def check_report(report: dict) -> list[str]:
    """Every time and MCD must be a finite number, and levers a and c must
    move the mel (an MCD of 0 means the switch was a no-op)."""
    bad = []

    def numbers(d):
        return [v for k, v in d.items() if k.endswith(("_ms", "_db")) and v is not None]

    for name in ("lever_a_bf16_norm_stats", "lever_c_fp32_carry_cost"):
        lever = report[name]
        if not all(math.isfinite(v) for v in numbers(lever)):
            bad.append(f"{name}: {lever}")
        mcd = lever["mel_mcd_vs_baseline_db" if name.startswith("lever_a") else "mel_mcd_carry_gap_db"]
        if not mcd > 0:
            bad.append(f"{name}: MCD {mcd}: the switch left the mel unchanged")
    for case, entry in report["lever_b_conv_layout"].items():
        if not all(math.isfinite(v) for v in numbers(entry)):
            bad.append(f"lever_b {case}: {entry}")
    return bad


def main(argv=None) -> int:
    from matcha_tpu_torch import bench
    from matcha_tpu_torch.inference import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' for the harness)")
    ap.add_argument("--tiny", action="store_true", help="tiny widths at B=2, text 32, fine 128, for the tests")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises without a card
    point = (TINY_B, TINY_TX, TINY_Y_FINE_LEN) if args.tiny else (B, TX, Y_FINE_LEN)

    def build(**switches):
        return build_synth(device, tiny=args.tiny, **switches)

    t0 = time.time()
    cases = CONV_CASES if not args.tiny else tuple((n, t // 16, c // 40, o // 40, k, s)
                                                   for n, t, c, o, k, s in CONV_CASES)
    report = {
        "backend": device.type,
        "operating_point": {"B": point[0], "tx": point[1], "y_fine_len": point[2]},
        "lever_a_bf16_norm_stats": lever_a(build, point),
        "lever_b_conv_layout": lever_b(device, point[0], cases),
        "lever_c_fp32_carry_cost": lever_c(build, point),
        "compute_dtype": "bfloat16",
        "durations": bench.DURATIONS,
        "method": "utils/probe.inner_repeat: one CUDA-graph replay of the chain (stage B k=4, convs k=8)"
        if device.type == "cuda" else "inner-repeat, eager on the CPU (not a device time)",
        "device": bench.device_info(device),
    }
    report["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(report, indent=2), flush=True)
    bad = check_report(report)
    if bad:
        print(f"ab_stage_b_levers: failed readings: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
