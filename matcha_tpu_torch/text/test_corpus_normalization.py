"""Diff corpus texts against NeMo normalization output.

The port's own copy of ``matcha_tpu/text/test_corpus_normalization.py`` (same flags, same output);
it imports nothing of the JAX package.

CLI:  python -m matcha_tpu_torch.text.test_corpus_normalization --filelist train.csv

Shows every row whose text changes under normalization — used to audit
whether a corpus was transcribed in already-normalized form
(reference: matcha/text/test_corpus_normalization.py).
"""

from __future__ import annotations

import argparse

from matcha_tpu_torch.data.dataset import parse_filelist
from matcha_tpu_torch.text.phonemizers import normalize_text


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--filelist", required=True, action="append")
    parser.add_argument("--limit", type=int, default=50)
    args = parser.parse_args(argv)

    shown = 0
    total = changed = 0
    for filelist in args.filelist:
        for row in parse_filelist(filelist, require_ids=False):
            total += 1
            lang_code = row[2].split("-")[0]
            normalized = normalize_text(lang_code, row[3])
            if normalized != row[3]:
                changed += 1
                if shown < args.limit:
                    shown += 1
                    print(f"[{row[0]}]")
                    print(f"  corpus: {row[3]}")
                    print(f"  nemo:   {normalized}")
    print(f"{changed}/{total} rows change under normalization")


if __name__ == "__main__":
    main()
