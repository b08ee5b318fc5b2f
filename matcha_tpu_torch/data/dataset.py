"""Corpus dataset: CSV filelists + precomputed two-resolution mel caches.

Same on-disk contract as the reference (reference:
matcha/data/text_mel_datamodule.py:250-466):

  * CSV rows ``rel_path|speaker_id|language|text|phoneme_ids`` where the
    phoneme IDs (space-separated ints) were written back by corpus
    validation — raw text is never tokenized at training time
  * per-utterance mel caches under ``mel_dir``: ``<rel>.npy`` (coarse,
    hop 256) and ``<rel>.fine.npy`` (fine, hop 128), already normalized,
    stored channel-major (n_mels, T) for compatibility — loaded and
    transposed to this framework's time-major (T, n_mels) layout.

Pure numpy / host-side: the port's own copy of ``matcha_tpu/data/dataset.py``
without the ctypes native loader.  Batches are bucketed padded arrays (see
data/sampler.py), fed through the trainer's prefetch thread.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class Utterance:
    rel_path: str
    speaker: int
    language: str
    text: str
    phoneme_ids: np.ndarray  # (Tx,) int32


def parse_filelist(path: str | Path, require_ids: bool = True) -> list[list[str]]:
    rows = []
    with open(path, newline="", encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="|", quoting=csv.QUOTE_NONE):
            if not row or not row[0].strip():
                continue
            if len(row) < 4:
                raise ValueError(f"Malformed corpus row: {row}")
            if require_ids and len(row) < 5:
                raise RuntimeError(
                    f"No precomputed phoneme IDs for {row[0]!r}; run the "
                    "corpus validation tool first."
                )
            rows.append(row)
    return rows


class TextMelDataset:
    """Index-addressable corpus view over precomputed mels."""

    def __init__(
        self,
        filelist_path: str | Path,
        mel_dir: str | Path,
        n_feats: int | None = None,
    ):
        self.mel_dir = Path(mel_dir)
        self.rows = parse_filelist(filelist_path)
        if n_feats is None:
            # the precompute tool writes the channel count to metadata.json;
            # fall back to the production default
            meta = self.mel_dir / "metadata.json"
            if meta.exists():
                import json

                n_feats = int(json.loads(meta.read_text()).get("n_mels", 100))
            else:
                n_feats = 100
        self.n_feats = n_feats

    def __len__(self) -> int:
        return len(self.rows)

    def utterance(self, index: int) -> Utterance:
        row = self.rows[index]
        return Utterance(
            rel_path=row[0],
            speaker=int(row[1]),
            language=row[2],
            text=row[3],
            phoneme_ids=np.asarray([int(t) for t in row[4].split()], np.int32),
        )

    def mel_paths(self, index: int) -> tuple[Path, Path]:
        rel = self.rows[index][0]
        return self.mel_dir / f"{rel}.npy", self.mel_dir / f"{rel}.fine.npy"

    def mel_length(self, index: int) -> int:
        """Coarse frame count, read from the npy header without loading data.

        (reference reads lengths via mmap for the dynamic sampler,
        text_mel_datamodule.py:73-87)
        """
        coarse, _ = self.mel_paths(index)
        # open_memmap reads only the header; no data pages are touched
        shape = np.lib.format.open_memmap(coarse, mode="r").shape
        if len(shape) != 2:
            return shape[0]
        # caches are (n_mels, T) channel-major; tolerate time-major too
        return shape[1] if shape[0] == self.n_feats else shape[0]

    def __getitem__(self, index: int) -> dict:
        utt = self.utterance(index)
        coarse_path, fine_path = self.mel_paths(index)
        y = np.load(coarse_path).astype(np.float32)
        y_fine = np.load(fine_path).astype(np.float32)
        if y.ndim != 2 or y_fine.ndim != 2:
            raise ValueError(f"Bad mel cache for {utt.rel_path}")
        # channel-major caches → time-major (decided by the known channel
        # count, NOT by which dim is smaller — short clips can have T < C)
        if y.shape[0] == self.n_feats:
            y, y_fine = y.T, y_fine.T
        return {
            "x": utt.phoneme_ids,
            "y": y,
            "y_fine": y_fine,
            "spk": utt.speaker,
            "filepath": utt.rel_path,
        }

    def filter_speaker(self, speaker: int) -> "TextMelDataset":
        """Dataset restricted to one speaker (speaker fine-tuning flow;
        reference: matcha/finetune_speaker.py:48-55)."""
        out = TextMelDataset.__new__(TextMelDataset)
        out.mel_dir = self.mel_dir
        out.n_feats = self.n_feats
        out.rows = [r for r in self.rows if int(r[1]) == speaker]
        return out
