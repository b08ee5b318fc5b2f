"""Reference-free MOS prediction (UTMOS) per speaker.

CLI:  python -m matcha_tpu_torch.utils.utmos_validate \
          --checkpoint_path ... --vocoder_path ... --filelist validate.csv \
          [--samples_per_speaker 20] [--device cpu]

The port's counterpart of ``matcha_tpu/utils/utmos_validate.py``.
Synthesizes samples on the card (unless ``--device cpu``) and scores them
there with the UTMOS predictor (`tarepan/SpeechMOS` via torch.hub, exactly
the model the reference uses — matcha/utils/utmos_validate.py:99-122).
The predictor download needs network access; in an air-gapped environment
pre-seed the torch.hub cache (~/.cache/torch/hub) or pass --hub_dir.
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np
import torch

from matcha_tpu_torch.checkpoint import load_synthesizer
from matcha_tpu_torch.data.dataset import parse_filelist

SAMPLE_RATE = 24000


def load_utmos(hub_dir: str | None = None, device=None):
    """The UTMOS predictor on ``device``, from torch.hub."""
    if hub_dir:
        torch.hub.set_dir(hub_dir)
    try:
        predictor = torch.hub.load("tarepan/SpeechMOS:v1.2.0", "utmos22_strong", trust_repo=True)
    except Exception as exc:
        raise SystemExit(
            "UTMOS predictor unavailable (torch.hub load failed — this tool "
            f"needs network access or a pre-seeded hub cache): {exc}"
        )
    return predictor.to(device).eval()


def score(predictor, wav: np.ndarray, device) -> float:
    """UTMOS of one waveform, scored on ``device``."""
    with torch.inference_mode():
        return float(predictor(torch.from_numpy(np.ascontiguousarray(wav))[None].to(device), SAMPLE_RATE))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--vocoder_path", required=True)
    parser.add_argument("--filelist", required=True)
    parser.add_argument("--samples_per_speaker", type=int, default=20)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--hub_dir", default=None)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    synth = load_synthesizer(args.checkpoint_path, args.vocoder_path, device=args.device)
    predictor = load_utmos(args.hub_dir, synth.device)

    rows_by_spk = defaultdict(list)
    for row in parse_filelist(args.filelist):
        rows_by_spk[int(row[1])].append(row)

    all_scores = []
    for spk in sorted(rows_by_spk):
        scores = []
        for row in rows_by_spk[spk][: args.samples_per_speaker]:
            ids = [int(t) for t in row[4].split()]
            result = synth.synthesise_ids(ids, speaker=spk, n_timesteps=args.steps)
            scores.append(score(predictor, result.wav, synth.device))
        avg = float(np.mean(scores))
        all_scores.extend(scores)
        print(f"speaker {spk:>3}: UTMOS {avg:.2f} (n={len(scores)})")
    print(f"average UTMOS: {np.mean(all_scores):.2f}")


if __name__ == "__main__":
    main()
