"""Padding-waste analyzer for the bucketed batch sampler.

The port's own copy of ``matcha_tpu/data/analyze_padding.py`` (same flags, same output);
it imports nothing of the JAX package.

CLI:  python -m matcha_tpu_torch.data.analyze_padding --filelist train.csv --mel_dir mels
      (or --synthetic N for a quick synthetic-length run)

Compares bucketed frame-budget batching against naive fixed batching over
several epochs: padding waste, batch-shape (compile-cache) footprint, and
epoch-to-epoch co-occurrence diversity — the decision data behind the
sampler design (reference: the DynamicBatchSampler __main__ analyzer,
matcha/data/text_mel_datamodule.py:521-660).
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np

from matcha_tpu_torch.data.sampler import BucketedBatchSampler


def analyze(lengths: list[int], max_frames: int, len_bucket: int, epochs: int = 10):
    sampler = BucketedBatchSampler(
        lengths, max_frames_per_batch=max_frames, len_bucket=len_bucket
    )
    total_frames = sum(lengths)

    waste_per_epoch = []
    pair_counts = defaultdict(int)
    for epoch in range(epochs):
        padded = 0
        for plan in sampler.create_batches(epoch):
            padded += plan.mel_len * plan.batch_size
            for a in plan.indices:
                for b in plan.indices:
                    if a < b:
                        pair_counts[(a, b)] += 1
        waste_per_epoch.append(1.0 - total_frames / padded)

    # fixed-size baseline: sort-free batches of B=16 padded to batch max
    fixed_b = 16
    order = np.random.default_rng(0).permutation(len(lengths))
    fixed_padded = 0
    for i in range(0, len(order), fixed_b):
        chunk = [lengths[j] for j in order[i : i + fixed_b]]
        fixed_padded += max(chunk) * len(chunk)
    fixed_waste = 1.0 - total_frames / fixed_padded

    shapes = sampler.shape_set()
    print(f"utterances: {len(lengths)}, total {total_frames} frames")
    print(f"bucketed waste: {np.mean(waste_per_epoch):.1%} (fixed-batch baseline {fixed_waste:.1%})")
    print(f"distinct batch shapes (compile cache size): {len(shapes)}")
    print(f"shapes: {sorted(shapes)}")
    uniq_pairs = len(pair_counts)
    repeat = sum(1 for v in pair_counts.values() if v > epochs // 2)
    print(
        f"co-occurrence over {epochs} epochs: {uniq_pairs} distinct pairs, "
        f"{repeat} pairs repeat in >half the epochs"
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--filelist", default=None)
    parser.add_argument("--mel_dir", default=None)
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--max_frames", type=int, default=32000)
    parser.add_argument("--len_bucket", type=int, default=32)
    args = parser.parse_args(argv)

    if args.synthetic:
        rng = np.random.default_rng(0)
        # plausible 24k corpus profile: 1-12 s utterances at hop 256
        lengths = list(rng.integers(90, 1100, args.synthetic))
    else:
        from matcha_tpu_torch.data.dataset import TextMelDataset

        ds = TextMelDataset(args.filelist, args.mel_dir)
        lengths = [ds.mel_length(i) for i in range(len(ds))]
    analyze(lengths, args.max_frames, args.len_bucket)


if __name__ == "__main__":
    main()
