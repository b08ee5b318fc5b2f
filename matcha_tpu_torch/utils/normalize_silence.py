"""Rebuild corpus wavs with exact leading/trailing silence.

The port's own copy of ``matcha_tpu/utils/normalize_silence.py`` (same flags, same output);
it imports nothing of the JAX package.

CLI:  python -m matcha_tpu_torch.utils.normalize_silence --filelist train.csv \
          --wav_dir wavs [--lead_ms 200 --trail_ms 800] [--in_place]

Idempotent (integer-window arithmetic + pure zero padding), like the
reference tool (reference: matcha/utils/normalize_silence.py).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from matcha_tpu_torch.data.dataset import parse_filelist
from matcha_tpu_torch.utils.audio_io import read_wav, write_wav
from matcha_tpu_torch.utils.silence import normalize_silence


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--filelist", required=True, action="append")
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--out_dir", default=None, help="default: <wav_dir>-normalized")
    parser.add_argument("--in_place", action="store_true")
    parser.add_argument("--lead_ms", type=float, default=200.0)
    parser.add_argument("--trail_ms", type=float, default=800.0)
    parser.add_argument("--threshold_db", type=float, default=-60.0)
    args = parser.parse_args(argv)

    wav_dir = Path(args.wav_dir)
    out_dir = (
        wav_dir if args.in_place else Path(args.out_dir or f"{args.wav_dir}-normalized")
    )
    n = 0
    for filelist in args.filelist:
        for row in parse_filelist(filelist, require_ids=False):
            src = wav_dir / f"{row[0]}.wav"
            wav, sr = read_wav(src)
            fixed = normalize_silence(
                wav, sr, args.lead_ms, args.trail_ms, args.threshold_db
            )
            dst = out_dir / f"{row[0]}.wav"
            dst.parent.mkdir(parents=True, exist_ok=True)
            write_wav(dst, fixed, sr)
            n += 1
    print(f"normalized {n} wavs → {out_dir}")


if __name__ == "__main__":
    main()
