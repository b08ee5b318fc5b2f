"""Measured A/B of the fast ODE operating points on the card: euler/4 and
midpoint/2 against the production midpoint/4.

The port's counterpart of ``tools/ab_fast_solvers.py``.  euler/4 and
midpoint/2 run half the U-Net evaluations of midpoint/4 (4 against 8) on
the stage that holds most of a request's device time.  At the benchmark's
operating point (B=16, text 256, fine mel 1024, bf16) it measures:

  * stage B's device ms for each (solver, steps), from
    ``utils/probe.inner_repeat``: the chain of k decodes is captured as
    one CUDA graph and replayed, so fixed costs cancel; a point that
    cannot be captured raises (there is no eager fallback on the card);
  * the mel-space MCD (``utils/hw_parity.mel_mcd_db``) of each point
    against the midpoint/4 mel at the same weights and inputs.  At random
    weights this measures the solvers' truncation difference, not
    perceptual quality.  midpoint/4 is decoded twice, so its own row reads
    the run-to-run difference of one program: 0 when the decode is
    deterministic, and whatever it is otherwise.

The synthesizer is ``bench.build_synthesizer``'s: random weights from
seeds 0 and 1 and the duration head pinned at 4 fine frames a token, so
256 tokens fill the 1024 bucket.  Here the port departs from the JAX tool,
whose random duration head collapses to the 1-frame floor and fills only
part of the bucket.  The solver and step count are per-request fields of
the serving API ("solver", "steps"), so a fast point needs no code change.

    python -m matcha_tpu_torch.utils.ab_fast_solvers [--device cpu --tiny]

prints one JSON report (the JAX tool's keys, plus ``device`` with the
card's ``nvidia-smi`` name and power limit, and ``durations``) and exits
non-zero on any failure.  On the CPU the chains run eagerly: their times
are ``cpu_ms`` and the device fields are null.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

B, TX, Y_FINE_LEN = 16, 256, 1024  # the benchmark's headline operating point
TINY_B, TINY_TX, TINY_Y_FINE_LEN = 2, 32, 128

POINTS = (
    ("midpoint", 4),  # production default: 8 U-Net evaluations
    ("euler", 4),     # the reference's fast point: 4 evaluations
    ("midpoint", 2),  # euler/4's evaluation count, second order
    ("euler", 8),     # control: euler at the production evaluation count
)
REFERENCE = POINTS[0]
INPUTS = ("stage A of the benchmark's synthesizer (duration head pinned): every row fills the bucket; "
          "the JAX tool's random head fills part of it")


def unet_evals(solver: str, steps: int) -> int:
    return steps * (2 if solver == "midpoint" else 1)


def stage_b_inputs(synth, b: int = B, tx: int = TX, y_fine_len: int = Y_FINE_LEN):
    """Stage B's inputs from a real stage-A run (``_Replica.encode``) on the
    JAX tool's ids (``default_rng(0).integers(0, 600, (b, tx))``), speaker
    rows 0 and scale 1: (mu_x, durations, x_mask, totals), totals =
    min(sum(durations), y_fine_len)."""
    rep = synth.replicas[0]
    dev = rep.device
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 600, (b, tx))).to(dev)
    lengths = torch.full((b,), tx, dtype=torch.int64, device=dev)
    spk = torch.zeros((b, synth.cfg.spk_emb_dim), dtype=torch.float32, device=dev)
    scale = torch.ones((b, 1), dtype=torch.float32, device=dev)
    mu_x, durations, x_mask = rep.encode(x, lengths, spk, spk, scale)
    totals = torch.clamp(durations.sum(dim=1).to(torch.int64), max=y_fine_len)
    return mu_x, durations, x_mask, totals


def decode_mel(synth, inputs, solver: str, steps: int, y_fine_len: int = Y_FINE_LEN) -> np.ndarray:
    """Row 0's denormalized mel from ``_Replica.decode`` (float32 numpy)."""
    mu_x, durations, x_mask, totals = inputs
    mel, _, _ = synth.replicas[0].decode(mu_x, durations, x_mask, totals, y_fine_len=y_fine_len,
                                         n_timesteps=steps, solver=solver)
    out = mel[0].float().cpu().numpy()
    if not np.isfinite(out).all():
        raise RuntimeError(f"{solver}/{steps}: non-finite mel")
    return out


def probe_decode(synth, inputs, solver: str, steps: int, y_fine_len: int = Y_FINE_LEN,
                 k: int = 4, reps: int = 5) -> dict:
    """``inner_repeat`` over ``_Replica.decode`` at one point; the body sums
    every output (mel, waveform, encoder mel) in full, as the benchmark's
    probe does."""
    from matcha_tpu_torch.utils.probe import inner_repeat

    rep = synth.replicas[0]

    def body(acc, mu_x, durations, x_mask, totals):
        outs = rep.decode(mu_x + acc, durations, x_mask, totals, y_fine_len=y_fine_len,
                          n_timesteps=steps, solver=solver)
        return sum(o.float().sum() for o in outs if o is not None) * 1e-12

    return inner_repeat(body, *inputs, k=k, reps=reps)


def timing_fields(probe: dict, on_card: bool) -> dict:
    """The probe's reading under its name: device ms on the card, cpu ms
    (not a device time) on the CPU."""
    if on_card:
        return {"device_ms": probe["device_ms"], "fixed_ms": probe["fixed_ms"]}
    return {"device_ms": None, "fixed_ms": None, "cpu_ms": probe["device_ms"]}


def measure_points(synth, inputs, y_fine_len: int = Y_FINE_LEN, points=POINTS, k: int = 4,
                   reps: int = 5) -> dict:
    """{"solver/steps": unet_evals, times, mel MCD against midpoint/4}."""
    from matcha_tpu_torch.utils.hw_parity import mel_mcd_db

    on_card = synth.device.type == "cuda"
    mel_ref = decode_mel(synth, inputs, *REFERENCE, y_fine_len)  # warm-up and reference
    out = {}
    for solver, steps in points:
        key = f"{solver}/{steps}"
        mel = decode_mel(synth, inputs, solver, steps, y_fine_len)
        probe = probe_decode(synth, inputs, solver, steps, y_fine_len, k, reps)
        out[key] = {"unet_evals": unet_evals(solver, steps), **timing_fields(probe, on_card),
                    "mel_mcd_vs_midpoint4_db": round(mel_mcd_db(mel_ref, mel), 4),
                    "mel_max_abs_diff_vs_midpoint4": float(np.abs(mel - mel_ref).max())}
        print(f"[ab-fast] {key}: {out[key]}", file=sys.stderr)
    return out


def check_report(points: dict) -> list[str]:
    """Every point's time and MCD must be finite numbers."""
    bad = []
    for key, p in points.items():
        t = p["device_ms"] if p["device_ms"] is not None else p["cpu_ms"]
        if not (math.isfinite(t) and math.isfinite(p["mel_mcd_vs_midpoint4_db"])):
            bad.append(f"{key}: {p}")
    return bad


def main(argv=None) -> int:
    from matcha_tpu_torch import bench
    from matcha_tpu_torch.inference import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card; 'cpu' for the harness)")
    ap.add_argument("--tiny", action="store_true", help="tiny widths at B=2, text 32, fine 128, for the tests")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises without a card
    b, tx, fine = (TINY_B, TINY_TX, TINY_Y_FINE_LEN) if args.tiny else (B, TX, Y_FINE_LEN)

    t0 = time.time()
    cfg, vcfg = bench.configs("bfloat16", args.tiny)
    synth = bench.build_synthesizer(cfg, vcfg, device, args.tiny)
    with torch.inference_mode():
        inputs = stage_b_inputs(synth, b, tx, fine)
        points = measure_points(synth, inputs, fine)
    report = {
        "backend": device.type,
        "operating_point": {"B": b, "tx": tx, "y_fine_len": fine},
        "reference_point": "midpoint/4 (8 U-Net evals, production default)",
        "points": points,
        "compute_dtype": cfg.compute_dtype,
        "durations": bench.DURATIONS,
        "inputs": INPUTS,
        "totals": [int(inputs[3].min()), int(inputs[3].max())],
        "method": "utils/probe.inner_repeat k=4: one CUDA-graph replay of the k-decode chain" if device.type == "cuda"
        else "inner-repeat k=4, eager on the CPU (not a device time)",
        "device": bench.device_info(device),
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(report, indent=2), flush=True)
    bad = check_report(points)
    if bad:
        print(f"ab_fast_solvers: non-finite readings: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
