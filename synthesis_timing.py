"""End-to-end synthesis time of one checkout, at full width on the card.

    python3 synthesis_timing.py [ROOT]

Imports ``matcha_tpu_torch`` from ROOT (default: the directory of this
file), makes the full-width bf16 synthesizer with seeded random weights
(``chip_smoke.production_synthesizer``) and runs two phases of
``chip_smoke.py`` on it through the synthesizer's public entry points:
``model`` (B=1 fused latency over 10 requests, B=16 fused RTF over 3 calls,
one long request) and ``profile`` (host wall time and device busy time of
one B=1 and one B=16 call); then ``train_profile`` (wall and device busy
time of one B=62 x 512 training step at full width, bf16, over
``chip_smoke.write_corpus``'s synthetic corpus).  Prints the phases' lines,
then one JSON line with the card and the numbers to compare, the device's
busy time beside the time of its device-to-host copies (the audio's, at
B=1 and B=16).  The traces are read by this checkout's
``utils/trace_analysis.py``, whatever checkout ROOT is, so two checkouts
differ in the code timed and not in how it is read.  Needs a CUDA card.
To compare two checkouts, run each in its own process in turns on one
card: A, B, B, A.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import torch

from chip_smoke import phase_model, phase_profile, phase_train_profile, production_synthesizer, write_corpus


HERE = os.path.dirname(os.path.abspath(__file__))


def use_own_readers() -> None:
    """Put this checkout's ``utils/profiling.py`` and ``utils/trace_analysis.py``
    in place of ROOT's (``chip_smoke.device_breakdown`` imports them from
    ``matcha_tpu_torch.utils``; a checkout older than them lacks them)."""
    for name in ("profiling", "trace_analysis"):
        spec = importlib.util.spec_from_file_location(
            f"matcha_tpu_torch.utils.{name}", os.path.join(HERE, "matcha_tpu_torch", "utils", f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[spec.name] = module


def main() -> int:
    if not torch.cuda.is_available():
        print("synthesis_timing: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, root)
    from matcha_tpu_torch.ops.attention import masked_attention_fwd_count

    use_own_readers()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    synth = production_synthesizer("bfloat16")
    model = phase_model(synth, masked_attention_fwd_count)
    profile = phase_profile(synth)
    n_feats = synth.cfg.n_feats
    del synth
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="synthesis_timing_") as tmp:
        write_corpus(tmp, n_feats)
        train = phase_train_profile(tmp)["step"]
    print(json.dumps({
        "root": root, "card": smi,
        "b1_fused_latency_ms_p50": model["b1_fused_latency_ms_p50"],
        "b1_fused_latency_ms": model["b1_fused_latency_ms"],
        "b16_fused_rtf_median": model["b16_fused_rtf_median"],
        "profile": {k: {**{m: profile[k][m] for m in ("wall_ms", "device_busy_ms", "device_idle_share")},
                        "dtoh_copy_ms": profile[k]["kernels"]["Memcpy DtoH"]["ms"]}
                    for k in ("b1_fused", "b16_fused")},
        "train_step": {m: train[m] for m in ("wall_ms", "device_busy_ms", "device_idle_share")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
