"""Data module: datasets + bucketed samplers + batch iterators.

The port's own copy of ``matcha_tpu/data/datamodule.py``: it owns the two
``BucketedBatchSampler``s (validation sampling is deterministic, jitter 0,
so the val loss compares across epochs) and yields collated CPU batches,
their mels read by the native loader or numpy (``use_native``, as
``data/collate.py::collate`` takes it).
Moving them to the card stays with the trainer, whose prefetch thread
overlaps the copy with compute.
"""

from __future__ import annotations

from pathlib import Path

from matcha_tpu_torch.data.collate import epoch_batches
from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.data.sampler import BucketedBatchSampler


class TextMelDataModule:
    """Owns the data side of a training run: train/valid datasets, their
    bucketed samplers, and the collated-batch iterators.

    ``batch_multiple`` is the data-parallel divisibility constraint (every
    emitted batch size is a multiple of the mesh's data-axis extent); the
    Trainer derives it from its mesh and passes it in.
    """

    def __init__(
        self,
        train_dataset: TextMelDataset,
        valid_dataset: TextMelDataset | None = None,
        *,
        max_frames_per_batch: int = 32000,
        len_bucket: int = 32,
        text_bucket: int = 32,
        batch_multiple: int = 1,
        seed: int = 1234,
        use_native: bool | None = None,
    ):
        self.train_ds = train_dataset
        self.valid_ds = valid_dataset
        self.max_frames_per_batch = max_frames_per_batch
        self.len_bucket = len_bucket
        self.text_bucket = text_bucket
        self.batch_multiple = batch_multiple
        self.seed = seed
        self.use_native = use_native

        lengths = [
            train_dataset.mel_length(i) for i in range(len(train_dataset))
        ]
        self.train_sampler = BucketedBatchSampler(
            lengths,
            max_frames_per_batch=max_frames_per_batch,
            len_bucket=len_bucket,
            seed=seed,
            batch_multiple=batch_multiple,
        )
        if valid_dataset is not None and len(valid_dataset):
            v_lengths = [
                valid_dataset.mel_length(i) for i in range(len(valid_dataset))
            ]
            self.valid_sampler = BucketedBatchSampler(
                v_lengths,
                max_frames_per_batch=max_frames_per_batch,
                len_bucket=len_bucket,
                jitter=0.0,
                seed=seed,
                batch_multiple=batch_multiple,
            )
        else:
            self.valid_sampler = None

    # ------------------------------------------------------------------

    @classmethod
    def from_files(
        cls,
        train_filelist_path: str | Path,
        mel_dir: str | Path,
        valid_filelist_path: str | Path | None = None,
        **kwargs,
    ) -> "TextMelDataModule":
        """Build datasets from CSV filelists, mirroring the reference's
        ``setup()`` (reference: matcha/data/text_mel_datamodule.py:289-322).
        A missing/empty valid filelist yields a train-only module."""
        train_ds = TextMelDataset(train_filelist_path, mel_dir)
        valid_ds = None
        if valid_filelist_path and Path(valid_filelist_path).exists():
            valid_ds = TextMelDataset(valid_filelist_path, mel_dir)
        return cls(train_ds, valid_ds, **kwargs)

    def replace_datasets(
        self,
        train_dataset: TextMelDataset,
        valid_dataset: TextMelDataset | None = None,
    ) -> "TextMelDataModule":
        """New module over different datasets, same bucketing knobs (e.g.
        finetune_speaker's speaker-filtered corpus)."""
        return TextMelDataModule(
            train_dataset,
            valid_dataset,
            max_frames_per_batch=self.max_frames_per_batch,
            len_bucket=self.len_bucket,
            text_bucket=self.text_bucket,
            batch_multiple=self.batch_multiple,
            seed=self.seed,
            use_native=self.use_native,
        )

    # ------------------------------------------------------------------

    def train_batches(self, epoch: int, shard: tuple[int, int] | None = None):
        """Collated train batches for one epoch (fresh jittered packing per
        epoch, stable batch count — the reference's dynamic-sampler
        re-create-on-epoch contract); ``shard`` = (rank, world) yields that
        rank's block of each batch."""
        return epoch_batches(
            self.train_ds, self.train_sampler, epoch, self.text_bucket, shard, self.use_native
        )

    def valid_batches(self, shard: tuple[int, int] | None = None):
        """Deterministic validation batches (same packing every call)."""
        if self.valid_sampler is None:
            return iter(())
        return epoch_batches(
            self.valid_ds, self.valid_sampler, 0, self.text_bucket, shard, self.use_native
        )

    @property
    def has_valid(self) -> bool:
        return self.valid_sampler is not None

    def shape_set(self) -> set[tuple[int, int]]:
        """Union of (batch, mel_len) program shapes both splits will emit —
        the training compile-cache budget (documentation/performance.md)."""
        shapes = set(self.train_sampler.shape_set())
        if self.valid_sampler is not None:
            shapes |= self.valid_sampler.shape_set()
        return shapes
