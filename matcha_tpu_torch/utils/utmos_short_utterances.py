"""UTMOS on short-vs-long utterance buckets per language.

CLI:  python -m matcha_tpu_torch.utils.utmos_short_utterances \
          --checkpoint_path ... --vocoder_path ... --filelist validate.csv [--device cpu]

The port's counterpart of ``matcha_tpu/utils/utmos_short_utterances.py``.
Buckets validation utterances by text length (short ≤ --short_chars) and
language, then reports UTMOS per (language, bucket) — the tool the
reference used to chase short-utterance quality regressions
(reference: matcha/utils/utmos_short_utterances.py).  Synthesis and scoring
run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np

from matcha_tpu_torch.checkpoint import load_synthesizer
from matcha_tpu_torch.data.dataset import parse_filelist
from matcha_tpu_torch.utils.utmos_validate import load_utmos, score


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--vocoder_path", required=True)
    parser.add_argument("--filelist", required=True)
    parser.add_argument("--short_chars", type=int, default=25)
    parser.add_argument("--samples_per_bucket", type=int, default=20)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--hub_dir", default=None)
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args(argv)

    synth = load_synthesizer(args.checkpoint_path, args.vocoder_path, device=args.device)
    predictor = load_utmos(args.hub_dir, synth.device)

    buckets = defaultdict(list)  # (lang, "short"|"long") -> rows
    for row in parse_filelist(args.filelist):
        kind = "short" if len(row[3]) <= args.short_chars else "long"
        buckets[(row[2], kind)].append(row)

    for (lang, kind) in sorted(buckets):
        rows = buckets[(lang, kind)][: args.samples_per_bucket]
        scores = []
        for row in rows:
            ids = [int(t) for t in row[4].split()]
            result = synth.synthesise_ids(ids, speaker=int(row[1]), n_timesteps=args.steps)
            scores.append(score(predictor, result.wav, synth.device))
        print(f"{lang:>6} {kind:>5}: UTMOS {np.mean(scores):.2f} (n={len(scores)})")


if __name__ == "__main__":
    main()
