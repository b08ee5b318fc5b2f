"""Port parity: sampler, dataset and collate against the JAX package's.

One synthetic corpus (CSV filelist + channel-major coarse and fine .npy
mels) and one seed: the port's BucketPlans equal the JAX package's for
several epochs, and its collated arrays equal the JAX numpy collate's
exactly (nothing is computed, only padded).
"""

import dataclasses

import numpy as np
import pytest

from matcha_tpu.data.collate import collate as jax_collate
from matcha_tpu.data.datamodule import TextMelDataModule as JaxDataModule
from matcha_tpu.data.dataset import TextMelDataset as JaxDataset
from matcha_tpu.data.sampler import BucketedBatchSampler as JaxSampler
from matcha_tpu_torch.data.collate import collate
from matcha_tpu_torch.data.datamodule import TextMelDataModule
from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.data.sampler import BucketedBatchSampler

N_FEATS = 8


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("portcorpus")
    mel_dir = root / "mels"
    (mel_dir / "s").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(40):
        rel = f"s/u{i}"
        frames = int(rng.integers(12, 120))
        np.save(mel_dir / f"{rel}.npy", rng.standard_normal((N_FEATS, frames)).astype(np.float32))
        np.save(mel_dir / f"{rel}.fine.npy", rng.standard_normal((N_FEATS, 2 * frames)).astype(np.float32))
        ids = " ".join(str(v) for v in rng.integers(0, 600, rng.integers(5, 40)))
        rows.append(f"{rel}|{i % 4}|en-us|text {i}|{ids}")
    (mel_dir / "metadata.json").write_text('{"n_mels": %d}' % N_FEATS)
    filelist = root / "train.csv"
    filelist.write_text("\n".join(rows))
    return filelist, mel_dir


@pytest.mark.parametrize("geometric", [True, False])
def test_sampler_plans_equal_jax(geometric):
    lengths = list(np.random.default_rng(1).integers(20, 1100, 300))
    kw = dict(max_frames_per_batch=32000, len_bucket=32, seed=3, geometric=geometric)
    ours, ref = BucketedBatchSampler(lengths, **kw), JaxSampler(lengths, **kw)
    assert ours.ladder == ref.ladder
    assert ours.shape_set() == ref.shape_set()
    for epoch in range(3):
        a, b = ours.create_batches(epoch), ref.create_batches(epoch)
        assert [dataclasses.asdict(p) for p in a] == [dataclasses.asdict(p) for p in b]


def test_production_ladder_batch_sizes():
    s = BucketedBatchSampler([500, 1050], max_frames_per_batch=32000, len_bucket=32)
    assert s.bucket_for(500) == 512 and s.batch_size_for(512) == 62
    assert s.bucket_for(1050) == 1088 and s.batch_size_for(1088) == 29


def test_dataset_and_collate_equal_jax(corpus):
    filelist, mel_dir = corpus
    ds, jds = TextMelDataset(filelist, mel_dir), JaxDataset(filelist, mel_dir)
    assert [ds.mel_length(i) for i in range(len(ds))] == [jds.mel_length(i) for i in range(len(jds))]
    dm = TextMelDataModule(ds, max_frames_per_batch=256, len_bucket=16, text_bucket=16, seed=5)
    jdm = JaxDataModule(jds, max_frames_per_batch=256, len_bucket=16, text_bucket=16, seed=5)
    plans = dm.train_sampler.create_batches(0)
    assert [dataclasses.asdict(p) for p in plans] == [
        dataclasses.asdict(p) for p in jdm.train_sampler.create_batches(0)]
    assert any(p.n_real < p.batch_size for p in plans)  # repeat-fill is exercised
    for plan in plans:
        ours = collate(ds, plan, text_bucket=16)
        ref = jax_collate(jds, plan, text_bucket=16, use_native=False)
        for name, a, b in zip(ours._fields, ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_train_batches_iterate_the_epoch(corpus):
    filelist, mel_dir = corpus
    dm = TextMelDataModule(TextMelDataset(filelist, mel_dir), max_frames_per_batch=256,
                           len_bucket=16, text_bucket=16, seed=5)
    batches = list(dm.train_batches(0))
    assert len(batches) == len(dm.train_sampler.create_batches(0))
    assert all(b.y_fine.shape[1] == 2 * b.y.shape[1] for b in batches)
