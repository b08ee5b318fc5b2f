"""Streaming corpus-wide mel mean/std (pre-normalization statistics).

CLI:  python -m matcha_tpu_torch.utils.generate_data_statistics \
          --filelist train.csv --wav_dir wavs/ [--device cpu]

Computes E[x] and E[x²] over every (coarse) log-mel value in the corpus in
one pass, accumulated in float64 on the host, and prints the
``data_statistics`` block for the training config, as
``matcha_tpu/utils/generate_data_statistics.py`` does.  Refuses to run
against an existing mel cache: cached mels are already normalized, so
statistics from them would be circular.  The mels are computed on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from matcha_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
from matcha_tpu_torch.data.dataset import parse_filelist
from matcha_tpu_torch.inference import resolve_device
from matcha_tpu_torch.utils.audio_io import read_wav


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--filelist", required=True, action="append")
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--mel_dir", default=None, help="guard: refuse if cache exists")
    parser.add_argument("--sample_rate", type=int, default=24000)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    if args.mel_dir and any(Path(args.mel_dir).rglob("*.npy")):
        raise SystemExit(
            "Mel cache already exists — its mels are normalized; statistics "
            "must come from raw audio. Delete the cache or omit --mel_dir."
        )

    device = resolve_device(args.device)
    cfg = MelConfig(sample_rate=args.sample_rate)
    total = 0
    s1 = 0.0
    s2 = 0.0
    for filelist in args.filelist:
        for row in parse_filelist(filelist, require_ids=False):
            wav, sr = read_wav(Path(args.wav_dir) / f"{row[0]}.wav")
            if sr != args.sample_rate:
                raise SystemExit(f"{row[0]}: sample rate {sr} != {args.sample_rate}")
            mel = log_mel_spectrogram(torch.from_numpy(wav).to(device), cfg)
            mel = mel.cpu().numpy().astype(np.float64)
            total += mel.size
            s1 += mel.sum()
            s2 += np.square(mel).sum()

    mean = s1 / total
    std = float(np.sqrt(s2 / total - mean * mean))
    print("data_statistics:")
    print(f"  mel_mean: {mean:.6f}")
    print(f"  mel_std: {std:.6f}")


if __name__ == "__main__":
    main()
