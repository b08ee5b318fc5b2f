"""Validate corpus texts against the frozen symbol inventory and write

The port's own copy of ``matcha_tpu/utils/validate_corpus_ipa.py`` (same flags, same output);
it imports nothing of the JAX package.
precomputed phoneme IDs back into column 5 of the CSV (atomically).

CLI:  python -m matcha_tpu_torch.utils.validate_corpus_ipa --filelist train.csv

Rows whose phonemization yields symbols outside the inventory are reported;
valid rows get their (pre, P, post)-expanded ID sequence cached so training
never needs eSpeak (reference: matcha/utils/validate_corpus_ipa.py:80-96).
"""

from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path

from matcha_tpu_torch.data.dataset import parse_filelist
from matcha_tpu_torch.text.phonemizers import (
    cleanup_text,
    normalize_text,
    phonemize,
    tokenize_phonemes,
)
from matcha_tpu_torch.text.symbols import symbol_to_id


def validate_and_tokenize(text: str, language: str) -> tuple[list[int], set[str]]:
    lang_code = language.split("-")[0]
    processed = cleanup_text(normalize_text(lang_code, text))
    ipa = phonemize(processed, language)
    unknown = {ch for ch in ipa if ch not in symbol_to_id}
    if unknown:
        return [], unknown
    _, ids = tokenize_phonemes(ipa)
    return ids, set()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--filelist", required=True, action="append")
    parser.add_argument("--force", action="store_true", help="retokenize rows with IDs")
    args = parser.parse_args(argv)

    for filelist in args.filelist:
        rows = parse_filelist(filelist, require_ids=False)
        bad = 0
        changed = 0
        out_rows = []
        for row in rows:
            if len(row) >= 5 and row[4].strip() and not args.force:
                out_rows.append(row)
                continue
            rel, spk, lang, text = row[0], row[1], row[2], row[3]
            ids, unknown = validate_and_tokenize(text, lang)
            if unknown:
                bad += 1
                print(f"[!] {rel}: unknown symbols {sorted(unknown)}")
                out_rows.append(row[:4])
            else:
                out_rows.append([rel, spk, lang, text, " ".join(map(str, ids))])
                changed += 1

        # atomic rewrite: write temp file in the same dir, then replace
        path = Path(filelist)
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            for row in out_rows:
                f.write("|".join(str(c) for c in row) + "\n")
        os.replace(tmp, path)
        print(f"{filelist}: tokenized={changed} invalid={bad} total={len(rows)}")


if __name__ == "__main__":
    main()
