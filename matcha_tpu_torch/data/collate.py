"""Batch assembly: dataset items → one padded, bucketed ``Batch``.

The port's own copy of ``matcha_tpu/data/collate.py`` (numpy path only; the
ctypes native loader is not ported).  Pads phoneme ids, coarse mel and fine
mel to the bucket shapes the sampler chose; the fine mel is exactly twice
the coarse length.  Repeat-filled tail rows get loss weight 0.  The arrays
become CPU tensors; the trainer moves them to the card.  Under data
parallelism each rank collates only its contiguous block of a plan's rows,
padded to the text bucket of the whole plan, so every rank's batch has the
global batch's shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.data.sampler import BucketPlan, round_up
from matcha_tpu_torch.parallel.mesh import row_block
from matcha_tpu_torch.train.step import Batch


def collate_numpy(dataset: TextMelDataset, plan: BucketPlan, text_bucket: int = 32,
                  shard: tuple[int, int] | None = None) -> tuple:
    """One padded batch as numpy arrays, in ``Batch`` field order;
    ``shard`` = (rank, world) keeps that rank's block of rows."""
    ty = plan.mel_len
    utts = [dataset.utterance(i) for i in plan.indices]
    tx = round_up(max(len(u.phoneme_ids) for u in utts), text_bucket)

    n_real = plan.n_real if plan.n_real >= 0 else plan.batch_size
    weights = np.zeros((plan.batch_size,), np.float32)
    weights[:n_real] = 1.0
    indices = plan.indices
    if shard is not None:
        rows = row_block(plan.batch_size, *shard)
        utts, indices, weights = utts[rows], indices[rows], weights[rows]
    b = len(indices)

    x = np.zeros((b, tx), np.int32)
    x_lengths = np.zeros((b,), np.int32)
    spks = np.zeros((b,), np.int32)
    for k, u in enumerate(utts):
        n = len(u.phoneme_ids)
        x[k, :n] = u.phoneme_ids
        x_lengths[k] = n
        spks[k] = u.speaker

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
            shard: tuple[int, int] | None = None) -> Batch:
    """One padded batch (or a rank's block of it) as CPU tensors."""
    return Batch(*map(torch.from_numpy, collate_numpy(dataset, plan, text_bucket, shard)))


def epoch_batches(dataset: TextMelDataset, sampler, epoch: int, text_bucket: int = 32,
                  shard: tuple[int, int] | None = None):
    """The epoch's plans, collated one at a time (the trainer's prefetch
    thread runs this generator ahead of the steps)."""
    for plan in sampler.create_batches(epoch):
        yield collate(dataset, plan, text_bucket, shard)
