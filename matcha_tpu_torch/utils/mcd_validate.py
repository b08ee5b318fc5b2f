"""Corpus-level MCD validation: synthesize validate.csv samples and score
against ground truth with DTW-MCD.

CLI:  python -m matcha_tpu_torch.utils.mcd_validate \
          --checkpoint_path <ckpt_dir> --vocoder_path vocos.pkl \
          --filelist validate.csv --wav_dir wavs [--samples_per_speaker 20] [--device cpu]

The port's counterpart of ``matcha_tpu/utils/mcd_validate.py``: per-speaker
MCD average and duration ratio (synthesis / reference length).  Synthesis
uses the phoneme IDs from the CSV and the fixed ODE noise row, so results
repeat run to run; it runs on the card unless ``--device cpu``, as does
the ``mel`` basis's log-mel.
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np

from matcha_tpu_torch.checkpoint import load_synthesizer
from matcha_tpu_torch.data.dataset import parse_filelist
from matcha_tpu_torch.utils.audio_io import read_wav
from matcha_tpu_torch.utils.mcd import mcd_dtw


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--vocoder_path", required=True)
    parser.add_argument("--filelist", required=True)
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--samples_per_speaker", type=int, default=20)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--solver", default="midpoint")
    parser.add_argument(
        "--mcd_basis", default="auto", choices=["auto", "pymcd", "sptk", "mel"],
        help="auto = pymcd toolbox when installed (reference-comparable), else sptk",
    )
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    synth = load_synthesizer(args.checkpoint_path, args.vocoder_path, device=args.device)
    rows_by_spk = defaultdict(list)
    for row in parse_filelist(args.filelist):
        rows_by_spk[int(row[1])].append(row)

    all_scores = []
    for spk in sorted(rows_by_spk):
        rows = rows_by_spk[spk][: args.samples_per_speaker]
        scores, ratios = [], []
        for row in rows:
            ids = [int(t) for t in row[4].split()]
            result = synth.synthesise_ids(ids, speaker=spk, n_timesteps=args.steps, solver=args.solver)
            ref_wav, _ = read_wav(Path(args.wav_dir) / f"{row[0]}.wav")
            scores.append(mcd_dtw(ref_wav, result.wav, basis=args.mcd_basis, device=synth.device))
            ratios.append(len(result.wav) / max(len(ref_wav), 1))
        spk_avg = float(np.nanmean(scores))
        all_scores.extend(scores)
        print(
            f"speaker {spk:>3}: MCD {spk_avg:5.2f} dB  "
            f"duration ratio {np.mean(ratios):.2f}  (n={len(scores)})"
        )
    print(f"average MCD: {np.nanmean(all_scores):.2f} dB")
    return all_scores


if __name__ == "__main__":
    main()
