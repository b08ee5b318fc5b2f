"""Frame-budget batching with shape bucketing.

The port's own copy of ``matcha_tpu/data/sampler.py``: the same plans from
the same lengths and seed.

The reference's DynamicBatchSampler packs variable batches under a frame
budget with jittered sorting, redistribution, and epoch-stable batch counts
(reference: matcha/data/text_mel_datamodule.py:33-249) — but every batch has
a unique (B, T) shape, which on TPU would force a recompile per batch.

This sampler keeps the ideas (length-sorted greedy packing under
``max_frames_per_batch``, ±15% jitter so batch composition varies per epoch,
stable batch count) while quantizing every batch to a small static shape set:

  * mel length is rounded up to a multiple of ``len_bucket`` frames
  * batch size is a *function of the bucket*: B(L) = max_frames // L
  * short batches are filled by repeating members to keep shapes exact; the
    fill rows are EXCLUDED from the loss via per-row weights (``n_real``
    marks the genuine prefix; collate emits weight 0 for fill rows, and the
    training losses normalize by weighted counts), so repeat-fill is exactly
    gradient-neutral — the reference never duplicates samples
    (reference: matcha/data/text_mel_datamodule.py:111-133) and neither,
    effectively, do we

so the number of distinct compiled programs is at most the number of length
buckets.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass


def round_up(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple)


@dataclass
class BucketPlan:
    mel_len: int       # padded coarse-mel length for every sample in batch
    batch_size: int    # exact number of rows (after fill)
    indices: list[int]  # dataset indices; may contain repeats to fill
    n_real: int = -1   # genuine rows (prefix); fill rows get loss weight 0


class BucketedBatchSampler:
    def __init__(
        self,
        mel_lengths: list[int],
        max_frames_per_batch: int = 32000,
        len_bucket: int = 32,
        jitter: float = 0.15,
        seed: int = 0,
        stable_batch_count: bool = True,
        geometric: bool = True,
        geometric_step: float = 1.1,
        batch_multiple: int = 1,
    ):
        # every batch size is a multiple of this (e.g. the DP device count)
        self.batch_multiple = max(1, batch_multiple)
        self.mel_lengths = list(mel_lengths)
        self.max_frames = max_frames_per_batch
        self.len_bucket = len_bucket
        self.jitter = jitter
        self.seed = seed
        self.stable_batch_count = stable_batch_count
        self._target_batches: int | None = None
        # Geometric ladder caps the compile-cache size: padded lengths are
        # quantized to ~geometric_step-spaced rungs (each still a multiple
        # of len_bucket) instead of every len_bucket multiple — ~2x fewer
        # distinct (B, T) programs for ~1-2% extra padding.
        self.ladder: list[int] | None = None
        if geometric:
            rungs, v = [], float(len_bucket)
            while v <= max_frames_per_batch:
                rung = round_up(int(v), len_bucket)
                if not rungs or rung > rungs[-1]:
                    rungs.append(rung)
                v *= geometric_step
            self.ladder = rungs
        longest = self.bucket_for(max(self.mel_lengths))
        if longest > max_frames_per_batch:
            raise ValueError(
                f"Longest utterance ({longest} frames) exceeds the batch "
                f"frame budget ({max_frames_per_batch})"
            )

    def bucket_for(self, length: int) -> int:
        quantized = round_up(max(length, self.len_bucket), self.len_bucket)
        if self.ladder is None:
            return quantized
        for rung in self.ladder:
            if quantized <= rung:
                return rung
        return quantized

    def batch_size_for(self, bucket_len: int) -> int:
        b = max(1, self.max_frames // bucket_len)
        if b >= self.batch_multiple:
            b -= b % self.batch_multiple
        else:
            b = self.batch_multiple  # small-batch case: pad up via repeats
        return b

    def create_batches(self, epoch: int = 0) -> list[BucketPlan]:
        rng = random.Random(self.seed + epoch)
        # jittered sort: similar lengths cluster, composition varies per epoch
        keyed = sorted(
            range(len(self.mel_lengths)),
            key=lambda i: self.mel_lengths[i]
            * (1.0 + rng.uniform(-self.jitter, self.jitter)),
        )

        plans: list[BucketPlan] = []
        current: list[int] = []
        current_max = 0
        for idx in keyed:
            cand_max = max(current_max, self.mel_lengths[idx])
            bucket = self.bucket_for(cand_max)
            if current and (len(current) + 1) > self.batch_size_for(bucket):
                plans.append(self._finalize(current, current_max))
                current, current_max = [], 0
            current.append(idx)
            current_max = max(current_max, self.mel_lengths[idx])
        if current:
            plans.append(self._finalize(current, current_max))

        if self.stable_batch_count:
            if self._target_batches is None:
                self._target_batches = len(plans)
            elif len(plans) > self._target_batches:
                plans = plans[: self._target_batches]
            else:
                while len(plans) < self._target_batches:
                    plans.append(plans[rng.randrange(len(plans))])

        rng.shuffle(plans)
        return plans

    def _finalize(self, indices: list[int], max_len: int) -> BucketPlan:
        bucket = self.bucket_for(max_len)
        b = self.batch_size_for(bucket)
        filled = list(indices)
        k = 0
        while len(filled) < b:  # repeat members to hit the exact bucket B
            filled.append(indices[k % len(indices)])
            k += 1
        return BucketPlan(
            mel_len=bucket,
            batch_size=b,
            indices=filled[:b],
            n_real=min(len(indices), b),
        )

    def shape_set(self) -> set[tuple[int, int]]:
        """All (B, mel_len) shapes this corpus can produce (compile budget)."""
        shapes = set()
        for length in self.mel_lengths:
            bucket = self.bucket_for(length)
            shapes.add((self.batch_size_for(bucket), bucket))
        return shapes
