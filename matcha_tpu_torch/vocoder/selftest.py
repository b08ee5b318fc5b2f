"""Vocoder round-trip quality self-test.

CLI:  python -m matcha_tpu_torch.vocoder.selftest --vocoder_path vocos.pkl \
          --wav_dir mcd_validation [--pattern 'original_*.wav'] [--device cpu]

The port's counterpart of ``matcha_tpu/vocoder/selftest.py``: for each wav,
the log-mel from the port's extractor goes through the port's Vocos, and
MCD(original, vocoded) on the ``mel`` basis is the vocoder-only quality
floor, independent of the TTS model (bands: < 1.5 dB transparent, < 2.5
production, < 4 usable, above that problematic).  The vocoder's widths are
read off the pickle's shapes.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from matcha_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
from matcha_tpu_torch.checkpoint import load_vocos
from matcha_tpu_torch.inference import resolve_device
from matcha_tpu_torch.utils.audio_io import read_wav
from matcha_tpu_torch.utils.mcd import mcd_dtw
from matcha_tpu_torch.vocoder.vocos import Vocos


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--vocoder_path", required=True)
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--pattern", default="*.wav")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    params, cfg = load_vocos(args.vocoder_path)
    vocos = Vocos(cfg)
    vocos.load_state_dict(params)
    vocos.to(device).eval()
    mel_cfg = MelConfig(n_mels=cfg.input_channels)

    scores = []
    for wav_path in sorted(Path(args.wav_dir).glob(args.pattern)):
        wav, sr = read_wav(wav_path)
        if sr != cfg.sample_rate:
            print(f"[!] {wav_path.name}: skip (sr {sr})")
            continue
        with torch.no_grad():
            mel = log_mel_spectrogram(torch.from_numpy(wav).to(device), mel_cfg)[None]
            out = vocos(mel)[0].cpu().numpy()
        score = mcd_dtw(wav, out, device=device)
        scores.append(score)
        print(f"{wav_path.name}: MCD {score:.2f} dB")
    if scores:
        avg = float(np.mean(scores))
        band = (
            "transparent" if avg < 1.5
            else "production" if avg < 2.5
            else "usable" if avg < 4.0
            else "problematic"
        )
        print(f"average vocoder MCD: {avg:.2f} dB ({band})")
    return scores


if __name__ == "__main__":
    main()
