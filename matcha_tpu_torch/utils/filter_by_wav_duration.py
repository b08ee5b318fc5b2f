"""Drop corpus rows whose wav is longer than a duration cap.

The port's own copy of ``matcha_tpu/utils/filter_by_wav_duration.py`` (same flags, same output);
it imports nothing of the JAX package.

CLI:  python -m matcha_tpu_torch.utils.filter_by_wav_duration \
          --filelist train.csv --wav_dir wavs --max_seconds 12
(reference: matcha/utils/filter_by_wav_duration.py)
"""

from __future__ import annotations

import argparse
from pathlib import Path

from matcha_tpu_torch.data.dataset import parse_filelist
from matcha_tpu_torch.utils.audio_io import duration_seconds


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--filelist", required=True, action="append")
    parser.add_argument("--wav_dir", required=True)
    parser.add_argument("--max_seconds", type=float, default=12.0)
    args = parser.parse_args(argv)

    for filelist in args.filelist:
        rows = parse_filelist(filelist, require_ids=False)
        kept, dropped = [], 0
        for row in rows:
            if duration_seconds(Path(args.wav_dir) / f"{row[0]}.wav") < args.max_seconds:
                kept.append(row)
            else:
                dropped += 1
        Path(filelist).write_text(
            "\n".join("|".join(r) for r in kept) + ("\n" if kept else "")
        )
        print(f"{filelist}: kept={len(kept)} dropped={dropped}")


if __name__ == "__main__":
    main()
