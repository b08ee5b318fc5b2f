"""MCD for a folder of original/generated wav pairs.

CLI:  python -m matcha_tpu_torch.utils.compute_mcd --dir mcd_validation \
          [--generated_dir out] [--mcd_basis auto|pymcd|sptk|mel] [--device cpu]

The port's counterpart of ``matcha_tpu/utils/compute_mcd.py``: pairs
``original_speaker_NNN.wav`` with ``generated_speaker_NNN.wav`` (or
``speaker_NNN.wav`` in --generated_dir) and prints each pair's MCD and the
average.  The ``mel`` basis computes its log-mels on the card unless
``--device cpu``; the other bases are host numpy.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np

from matcha_tpu_torch.utils.audio_io import read_wav
from matcha_tpu_torch.utils.mcd import mcd_dtw


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dir", required=True, help="folder with original_*.wav")
    parser.add_argument("--generated_dir", default=None)
    parser.add_argument(
        "--mcd_basis", default="auto", choices=["auto", "pymcd", "sptk", "mel"],
        help="auto = pymcd toolbox when installed (reference-comparable), else sptk",
    )
    parser.add_argument("--device", default=None, help="the mel basis's device (default: the CUDA card)")
    args = parser.parse_args(argv)

    root = Path(args.dir)
    gen_root = Path(args.generated_dir) if args.generated_dir else root
    scores = []
    for orig in sorted(root.glob("original_*.wav")):
        stem = re.match(r"original_(.+)\.wav", orig.name).group(1)
        candidates = [gen_root / f"generated_{stem}.wav", gen_root / f"{stem}.wav"]
        gen = next((c for c in candidates if c.exists()), None)
        if gen is None:
            print(f"[!] no generated wav for {orig.name}")
            continue
        ref_wav, _ = read_wav(orig)
        syn_wav, _ = read_wav(gen)
        score = mcd_dtw(ref_wav, syn_wav, basis=args.mcd_basis, device=args.device)
        scores.append(score)
        print(f"{stem}: MCD {score:.2f} dB")
    if scores:
        print(f"average MCD: {np.mean(scores):.2f} dB over {len(scores)} pairs")
    return scores


if __name__ == "__main__":
    main()
