"""Batch assembly: dataset items → one padded, bucketed ``Batch``.

The port's own copy of ``matcha_tpu/data/collate.py``.  Pads phoneme ids,
coarse mel and fine mel to the bucket shapes the sampler chose; the fine mel
is exactly twice the coarse length.  Repeat-filled tail rows get loss
weight 0.  The arrays become CPU tensors; the trainer moves them to the
card.  Under data parallelism each rank collates only its contiguous block
of a plan's rows, padded to the text bucket of the whole plan, so every
rank's batch has the global batch's shapes.

The mels come either from numpy (``collate_numpy``) or from the native C++
loader (``data/native_loader.py``), which reads the caches on a thread pool
straight into the batch's tensors, pinned where a card will take them.
Both give the same batch.  ``use_native=None`` takes the native loader
where it builds, as the JAX package's ``collate`` does; ``True`` raises
where it does not.
"""

from __future__ import annotations

import numpy as np
import torch

from matcha_tpu_torch.data import native_loader
from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.data.sampler import BucketPlan, round_up
from matcha_tpu_torch.parallel.mesh import row_block
from matcha_tpu_torch.train.step import Batch


def _text_arrays(dataset: TextMelDataset, plan: BucketPlan, text_bucket: int, rows: slice):
    """Padded phoneme ids, their lengths, speakers and loss weights of the
    plan's ``rows``, and those rows' dataset indices."""
    utts = [dataset.utterance(i) for i in plan.indices]
    tx = round_up(max(len(u.phoneme_ids) for u in utts), text_bucket)
    n_real = plan.n_real if plan.n_real >= 0 else plan.batch_size
    weights = np.zeros((plan.batch_size,), np.float32)
    weights[:n_real] = 1.0
    utts, indices, weights = utts[rows], plan.indices[rows], weights[rows]
    x = np.zeros((len(utts), tx), np.int32)
    x_lengths = np.zeros((len(utts),), np.int32)
    spks = np.zeros((len(utts),), np.int32)
    for k, u in enumerate(utts):
        x[k, :len(u.phoneme_ids)] = u.phoneme_ids
        x_lengths[k] = len(u.phoneme_ids)
        spks[k] = u.speaker
    return x, x_lengths, spks, weights, indices


def collate_numpy(dataset: TextMelDataset, plan: BucketPlan, text_bucket: int = 32,
                  shard: tuple[int, int] | None = None) -> tuple:
    """One padded batch as numpy arrays, in ``Batch`` field order;
    ``shard`` = (rank, world) keeps that rank's block of rows."""
    rows = row_block(plan.batch_size, *shard) if shard is not None else slice(None)
    x, x_lengths, spks, weights, indices = _text_arrays(dataset, plan, text_bucket, rows)
    b, ty = len(indices), plan.mel_len

    items = [dataset[i] for i in indices]
    n_feats = items[0]["y"].shape[1]
    y = np.zeros((b, ty, n_feats), np.float32)
    y_lengths = np.zeros((b,), np.int32)
    y_fine = np.zeros((b, 2 * ty, n_feats), np.float32)
    y_fine_lengths = np.zeros((b,), np.int32)
    for k, it in enumerate(items):
        ny = min(it["y"].shape[0], ty)
        y[k, :ny] = it["y"][:ny]
        y_lengths[k] = ny
        nf = min(it["y_fine"].shape[0], 2 * ty)
        y_fine[k, :nf] = it["y_fine"][:nf]
        y_fine_lengths[k] = nf
    return x, x_lengths, y, y_lengths, y_fine, y_fine_lengths, spks, weights


def collate(dataset: TextMelDataset, plan: BucketPlan, text_bucket: int = 32,
            shard: tuple[int, int] | None = None, use_native: bool | None = None) -> Batch:
    """One padded batch (or a rank's block of it) as CPU tensors; the mels
    through the native loader (``use_native``; ``None``: where it builds)
    or numpy.  The native loader fills float32 tensors, pinned where CUDA is
    available, so the copy to the card needs no staging."""
    if use_native is None:
        use_native = native_loader.available()
    if not use_native:
        return Batch(*map(torch.from_numpy, collate_numpy(dataset, plan, text_bucket, shard)))
    rows = row_block(plan.batch_size, *shard) if shard is not None else slice(None)
    x, x_lengths, spks, weights, indices = _text_arrays(dataset, plan, text_bucket, rows)
    coarse, fine = zip(*(dataset.mel_paths(i) for i in indices))
    pin = torch.cuda.is_available()
    ty, n_feats = plan.mel_len, dataset.n_feats
    y = torch.empty((len(indices), ty, n_feats), dtype=torch.float32, pin_memory=pin)
    y_fine = torch.empty((len(indices), 2 * ty, n_feats), dtype=torch.float32, pin_memory=pin)
    _, y_lengths = native_loader.fill_batch(list(coarse), ty, n_feats, out=y)
    _, y_fine_lengths = native_loader.fill_batch(list(fine), 2 * ty, n_feats, out=y_fine)
    t = torch.from_numpy
    return Batch(t(x), t(x_lengths), y, t(y_lengths), y_fine, t(y_fine_lengths), t(spks), t(weights))


def epoch_batches(dataset: TextMelDataset, sampler, epoch: int, text_bucket: int = 32,
                  shard: tuple[int, int] | None = None, use_native: bool | None = None):
    """The epoch's plans, collated one at a time (the trainer's prefetch
    thread runs this generator ahead of the steps)."""
    for plan in sampler.create_batches(epoch):
        yield collate(dataset, plan, text_bucket, shard, use_native)
