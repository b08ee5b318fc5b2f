"""Segmented streaming synthesis: long text → sentence segments → chunks.

Beyond-reference capability.  The reference server caps requests at 1000
characters and returns one blob only after the FULL synthesis finishes
(reference: matcha/server.py:31,94-96 — `MAX_TEXT_LENGTH`, synchronous
handler).  Here a long input is split into sentence-aligned segments that
are submitted to the micro-batcher TOGETHER — they share padded device
programs, so total device work is the same as one big request — and each
segment's audio is yielded as soon as it (and every segment before it) is
done.  Time-to-first-audio becomes O(first segment), independent of total
text length, which is what long-form read-aloud clients need.

Segmentation guarantees:
* ``split_text``  — sentence-boundary packing up to ``max_chars``, with a
  word-boundary hard split for pathological run-on sentences.
* ``split_ids``   — pretokenized requests split at SPACE_ID (the silence
  token the phonemizer injects between words), nearest the target length;
  concatenating the segments always reproduces the input id list exactly.
"""

from __future__ import annotations

import re
import struct

from matcha_tpu_torch.text.symbols import SPACE_ID

SAMPLE_RATE = 24000

# one sentence = optional leading terminator/space run (an unattached
# "..." folds into the sentence that follows it, as a pause) + the
# non-terminator body + its terminators + trailing whitespace
_SENT_RE = re.compile(r"[.!?…\s]*[^.!?…]+[.!?…]*\s*", re.S)


def split_text(text: str, max_chars: int = 240) -> list[str]:
    """Split ``text`` into sentence-aligned segments of ≤ ``max_chars``.

    Whole sentences are packed greedily; a single sentence longer than
    ``max_chars`` is hard-split at word boundaries (never mid-word unless
    one "word" itself exceeds the budget).
    """
    sentences = [m.group(0) for m in _SENT_RE.finditer(text)]
    if not sentences and text.strip():
        # terminator-only input has no sentence body; pass it through whole
        # (the phonemizer decides whether it yields anything speakable)
        sentences = [text]
    packed: list[str] = []
    cur = ""
    for s in sentences:
        if cur and len(cur) + len(s) > max_chars:
            packed.append(cur)
            cur = s
        else:
            cur += s
    if cur.strip():
        packed.append(cur)

    out: list[str] = []
    for seg in packed:
        seg = seg.strip()
        while len(seg) > max_chars:
            cut = seg.rfind(" ", 1, max_chars)
            cut = cut if cut > 0 else max_chars
            out.append(seg[:cut])
            seg = seg[cut:].strip()
        if seg:
            out.append(seg)
    return out


def split_ids(ids, target: int = 120) -> list[list[int]]:
    """Split a phoneme-id list at SPACE_ID boundaries near ``target``.

    The trailing space stays with its segment (it is the inter-word
    silence, so each chunk ends in silence rather than mid-phoneme).
    Invariant: ``sum(split_ids(ids), []) == list(ids)``.
    """
    ids = [int(i) for i in ids]
    if len(ids) <= 2 * target:
        return [ids] if ids else []
    spaces = [i for i, t in enumerate(ids) if t == SPACE_ID]
    segs: list[list[int]] = []
    start = 0
    while len(ids) - start > 2 * target:
        cands = [i for i in spaces if start < i <= start + 2 * target]
        if cands:
            cut = min(cands, key=lambda i: abs(i - (start + target)))
        else:  # no silence in the window: hard cut
            cut = start + target
        segs.append(ids[start : cut + 1])
        start = cut + 1
    if start < len(ids):
        segs.append(ids[start:])
    return segs


def wav_stream_header(sample_rate: int = SAMPLE_RATE) -> bytes:
    """RIFF/WAVE header with unknown (maximal) sizes.

    The standard convention for streamed wav: players treat 0xFFFFFFFF
    chunk sizes as "read until the connection closes".  16-bit mono PCM.
    """
    return (
        b"RIFF"
        + struct.pack("<I", 0xFFFFFFFF)
        + b"WAVEfmt "
        + struct.pack(
            "<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16
        )
        + b"data"
        + struct.pack("<I", 0xFFFFFFFF)
    )
