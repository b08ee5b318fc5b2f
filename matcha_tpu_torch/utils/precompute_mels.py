"""Precompute normalized two-resolution mel caches for a corpus.

CLI:  python -m matcha_tpu_torch.utils.precompute_mels \
          --filelist data/corpus-24k/train.csv \
          --wav_dir data/corpus-24k/wavs --mel_dir data/corpus-24k/mels [--device cpu]

For every corpus row writes ``<rel>.npy`` (coarse hop=256) and
``<rel>.fine.npy`` (hop=128), both channel-major (n_mels, T), C-contiguous
fp32 and already normalized with the corpus statistics: the on-disk
contract of ``matcha_tpu/utils/precompute_mels.py``, which the port's
``data/dataset.py`` reads.  Also writes ``metadata.json`` (extraction
params) and ``failures.txt`` (rows rejected by the NaN/Inf guard or a wrong
sample rate).

The mels are computed on the card unless ``--device cpu``.  The wav is
trimmed to a multiple of the COARSE hop first, so the fine frame count is
exactly 2 x coarse - 1.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from matcha_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
from matcha_tpu_torch.data.dataset import parse_filelist
from matcha_tpu_torch.inference import resolve_device
from matcha_tpu_torch.utils.audio_io import read_wav
from matcha_tpu_torch.utils.model_math import normalize


def extract_pair(wav: np.ndarray, cfg: MelConfig, mel_mean: float, mel_std: float,
                 device=None) -> tuple[np.ndarray, np.ndarray]:
    """Returns (coarse, fine) normalized mels, channel-major (n_mels, T)."""
    t = (len(wav) // cfg.hop_length) * cfg.hop_length
    w = torch.from_numpy(np.ascontiguousarray(wav[:t], np.float32)).to(resolve_device(device))
    out = []
    for c in (cfg, cfg.fine):
        mel = normalize(log_mel_spectrogram(w, c), mel_mean, mel_std)
        # ascontiguousarray: np.save would store the transpose view
        # Fortran-ordered, breaking C-order cache readers
        out.append(np.ascontiguousarray(mel.T.cpu().numpy(), np.float32))
    return out[0], out[1]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--filelist", required=True, action="append")
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--mel_dir", required=True)
    parser.add_argument("--mel_mean", type=float, default=-4.684777)
    parser.add_argument("--mel_std", type=float, default=6.512275)
    parser.add_argument("--sample_rate", type=int, default=24000)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = MelConfig(sample_rate=args.sample_rate)
    mel_dir = Path(args.mel_dir)
    mel_dir.mkdir(parents=True, exist_ok=True)
    failures = []
    written = skipped = 0

    for filelist in args.filelist:
        for row in parse_filelist(filelist, require_ids=False):
            rel = row[0]
            coarse_path = mel_dir / f"{rel}.npy"
            fine_path = mel_dir / f"{rel}.fine.npy"
            if not args.overwrite and coarse_path.exists() and fine_path.exists():
                skipped += 1
                continue
            wav_path = Path(args.wav_dir) / f"{rel}.wav"
            try:
                wav, sr = read_wav(wav_path)
                if sr != args.sample_rate:
                    raise ValueError(f"sample rate {sr} != {args.sample_rate}")
                coarse, fine = extract_pair(wav, cfg, args.mel_mean, args.mel_std, device)
                if not (np.isfinite(coarse).all() and np.isfinite(fine).all()):
                    raise ValueError("NaN/Inf in extracted mel")
                coarse_path.parent.mkdir(parents=True, exist_ok=True)
                np.save(coarse_path, coarse)
                np.save(fine_path, fine)
                written += 1
            except Exception as exc:  # any bad row is recorded in failures.txt and skipped
                failures.append(f"{rel}\t{exc}")

    (mel_dir / "metadata.json").write_text(
        json.dumps(
            {
                "sample_rate": args.sample_rate,
                "n_fft": cfg.n_fft,
                "hop_length": cfg.hop_length,
                "fine_hop_length": cfg.hop_length // 2,
                "n_mels": cfg.n_mels,
                "mel_mean": args.mel_mean,
                "mel_std": args.mel_std,
            },
            indent=2,
        )
    )
    if failures:
        (mel_dir / "failures.txt").write_text("\n".join(failures))
    print(f"written={written} skipped={skipped} failures={len(failures)}")


if __name__ == "__main__":
    main()
