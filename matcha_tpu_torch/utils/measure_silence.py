"""Per-speaker leading/trailing silence statistics at TWO thresholds.

The port's own copy of ``matcha_tpu/utils/measure_silence.py`` (same flags, same output);
it imports nothing of the JAX package.

Each wav end is measured at an *effective* silence threshold (default -60 dB,
what listeners perceive as quiet) and an *absolute* one (default -90 dB,
near-digital-zero), over 10 ms RMS windows.  Reports per-speaker mean/std and
p50/p95 tables for both ends and both thresholds, plus the file with the
longest effective silence per speaker — the outliers normalize_silence should
be pointed at.

CLI (corpus):  python -m matcha_tpu_torch.utils.measure_silence --filelist train.csv --wav_dir wavs
CLI (single):  python -m matcha_tpu_torch.utils.measure_silence --file path/to.wav
(reference: matcha/utils/measure_silence.py)
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np

from matcha_tpu_torch.utils.audio_io import read_wav
from matcha_tpu_torch.utils.silence import WINDOW_MS, bounds_from_rms, rms_windows


def measure_silence_ms(
    wav: np.ndarray,
    sample_rate: int,
    effective_db: float = -60.0,
    absolute_db: float = -90.0,
) -> tuple[float, float, float, float]:
    """(lead_effective, lead_absolute, trail_effective, trail_absolute) in ms.

    Both thresholds share one window grid anchored at sample 0 (reference:
    measure_silence.py:66-120 computes RMS once and compares twice).
    """
    rms = rms_windows(wav, sample_rate)
    lead_e, trail_e = bounds_from_rms(rms, effective_db)
    lead_a, trail_a = bounds_from_rms(rms, absolute_db)
    return (
        lead_e * WINDOW_MS,
        lead_a * WINDOW_MS,
        trail_e * WINDOW_MS,
        trail_a * WINDOW_MS,
    )


def _print_table(title, eff, abs_, effective_db, absolute_db):
    print(f"\n{title} (effective: {effective_db} dB, absolute: {absolute_db} dB)")
    print("=" * 110)
    print(
        f"{'spk':<6} {'n':<7} {'eff mean':>9} {'eff std':>9} {'eff p50':>9}"
        f" {'eff p95':>9} {'abs mean':>9} {'abs std':>9} {'abs p50':>9} {'abs p95':>9}"
    )
    print("-" * 110)
    for spk in sorted(eff, key=lambda s: (len(s), s)):
        e = np.asarray(eff[spk])
        a = np.asarray(abs_[spk])
        print(
            f"{spk:<6} {len(e):<7}"
            f" {e.mean():>8.1f} {e.std():>8.1f}"
            f" {np.percentile(e, 50):>8.1f} {np.percentile(e, 95):>8.1f}"
            f" {a.mean():>8.1f} {a.std():>8.1f}"
            f" {np.percentile(a, 50):>8.1f} {np.percentile(a, 95):>8.1f}"
        )
    print("=" * 110)


def _print_longest(title, longest):
    print(f"\n{title}:")
    print("-" * 110)
    for spk in sorted(longest, key=lambda s: (len(s), s)):
        path, ms = longest[spk]
        print(f"speaker {spk}: {ms:.1f} ms - {path}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--filelist", action="append", default=[])
    parser.add_argument("--wav_dir")
    parser.add_argument("--file", help="measure a single wav and exit")
    parser.add_argument(
        "--effective_silence_threshold", "--threshold_db",
        dest="effective_db", type=float, default=-60.0,
    )
    parser.add_argument(
        "--absolute_silence_threshold", dest="absolute_db", type=float,
        default=-90.0,
    )
    args = parser.parse_args(argv)

    if args.file:
        wav, sr = read_wav(Path(args.file))
        le, la, te, ta = measure_silence_ms(
            wav, sr, args.effective_db, args.absolute_db
        )
        print(f"Leading  effective ({args.effective_db} dB): {le:.1f} ms")
        print(f"Leading  absolute  ({args.absolute_db} dB): {la:.1f} ms")
        print(f"Trailing effective ({args.effective_db} dB): {te:.1f} ms")
        print(f"Trailing absolute  ({args.absolute_db} dB): {ta:.1f} ms")
        return

    if not args.filelist or not args.wav_dir:
        parser.error("either --file or (--filelist and --wav_dir) is required")

    from matcha_tpu_torch.data.dataset import parse_filelist

    lead_eff = defaultdict(list)
    lead_abs = defaultdict(list)
    trail_eff = defaultdict(list)
    trail_abs = defaultdict(list)
    longest_lead: dict = {}
    longest_trail: dict = {}
    total = 0
    for filelist in args.filelist:
        for row in parse_filelist(filelist, require_ids=False):
            wav_path = Path(args.wav_dir) / f"{row[0]}.wav"
            wav, sr = read_wav(wav_path)
            le, la, te, ta = measure_silence_ms(
                wav, sr, args.effective_db, args.absolute_db
            )
            spk = row[1]
            lead_eff[spk].append(le)
            lead_abs[spk].append(la)
            trail_eff[spk].append(te)
            trail_abs[spk].append(ta)
            if spk not in longest_lead or le > longest_lead[spk][1]:
                longest_lead[spk] = (str(wav_path), le)
            if spk not in longest_trail or te > longest_trail[spk][1]:
                longest_trail[spk] = (str(wav_path), te)
            total += 1

    print(f"Total files processed: {total} ({WINDOW_MS:.0f} ms RMS windows)")
    _print_table(
        "Leading Silence Statistics", lead_eff, lead_abs,
        args.effective_db, args.absolute_db,
    )
    _print_table(
        "Trailing Silence Statistics", trail_eff, trail_abs,
        args.effective_db, args.absolute_db,
    )
    _print_longest(
        "Files with longest leading effective silence per speaker", longest_lead
    )
    _print_longest(
        "Files with longest trailing effective silence per speaker", longest_trail
    )


if __name__ == "__main__":
    main()
