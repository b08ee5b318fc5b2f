"""Sum total audio hours in a corpus.

The port's own copy of ``matcha_tpu/utils/total_corpus_duration.py`` (same flags, same output);
it imports nothing of the JAX package.

CLI:  python -m matcha_tpu_torch.utils.total_corpus_duration --filelist train.csv --wav_dir wavs
(reference: matcha/utils/total_corpus_duration.py)
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

from matcha_tpu_torch.data.dataset import parse_filelist
from matcha_tpu_torch.utils.audio_io import duration_seconds


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--filelist", required=True, action="append")
    parser.add_argument("--wav_dir", required=True)
    args = parser.parse_args(argv)

    per_spk = defaultdict(float)
    total = 0.0
    n = 0
    for filelist in args.filelist:
        for row in parse_filelist(filelist, require_ids=False):
            sec = duration_seconds(Path(args.wav_dir) / f"{row[0]}.wav")
            per_spk[row[1]] += sec
            total += sec
            n += 1
    for spk in sorted(per_spk, key=int):
        print(f"speaker {spk:>3}: {per_spk[spk] / 3600:.2f} h")
    print(f"total: {n} utterances, {total / 3600:.2f} h")


if __name__ == "__main__":
    main()
