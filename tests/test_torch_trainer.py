"""The port's Trainer end to end on the CPU: synthetic corpus → fit →
metrics.jsonl + checkpoint → served by load_synthesizer → resume.

The checkpoint's ``params`` tree is the flax layout: the JAX package's
model applies it as is, and its optimizer state sits under the JAX
trainer's optax key paths (``tests/test_torch_checkpoint_crossing.py``
resumes it in the JAX trainer).
"""

import json

import jax
import numpy as np
import pytest
import torch

from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import MatchaTTS as JaxMatchaTTS
from matcha_tpu_torch.checkpoint import load_checkpoint, load_synthesizer
from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.parallel import mesh
from matcha_tpu_torch.train.checkpoint import optax_state_parts
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig

CFG = tiny_config()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchtraincorpus")
    mel_dir = root / "mels"
    (mel_dir / "s").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(12):
        rel = f"s/u{i}"
        frames = int(rng.integers(12, 40))
        np.save(mel_dir / f"{rel}.npy", rng.standard_normal((CFG.n_feats, frames)).astype(np.float32))
        np.save(mel_dir / f"{rel}.fine.npy",
                rng.standard_normal((CFG.n_feats, 2 * frames)).astype(np.float32))
        ids = " ".join(str(v) for v in rng.integers(0, 600, rng.integers(5, 15)))
        rows.append(f"{rel}|{i % CFG.n_spks}|en-us|text {i}|{ids}")
    (mel_dir / "metadata.json").write_text('{"n_mels": %d}' % CFG.n_feats)
    filelist = root / "train.csv"
    filelist.write_text("\n".join(rows))
    return root, filelist, mel_dir


def make_trainer(corpus, out_name, **cfg_kw):
    root, filelist, mel_dir = corpus
    ds = TextMelDataset(filelist, mel_dir)
    tcfg = TrainerConfig(output_dir=str(root / out_name), check_val_every_n_epoch=1,
                         checkpoint_every_n_epochs=1, keep_last_checkpoints=2,
                         log_every_n_steps=1, **cfg_kw)
    return Trainer(CFG, OptimizerConfig(lr=1e-3), tcfg, ds, valid_dataset=ds,
                   max_frames_per_batch=256, len_bucket=16, text_bucket=16, device="cpu")


@pytest.fixture(scope="module")
def run1(corpus):
    trainer = make_trainer(corpus, "run1")
    try:
        state = trainer.fit(max_steps=3)
    finally:
        trainer.close()
    return corpus[0] / "run1", state


def test_fit_writes_metrics_and_a_checkpoint(run1):
    out, state = run1
    assert state.step == 3
    recs = [json.loads(line) for line in open(out / "metrics.jsonl")]
    keys = set().union(*recs)
    assert {"loss", "sub_loss/diff", "sub_loss/dur", "sub_loss/prior", "grad_norm",
            "loss/train_epoch", "model/params_total"} <= keys
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    ckpts = sorted((out / "checkpoints").glob("epoch_*"))
    assert 1 <= len(ckpts) <= 2
    tree, cfg = load_checkpoint(ckpts[-1])
    assert int(tree["step"]) == 3 and cfg.to_dict() == CFG.to_dict()
    adam, finite, _ = optax_state_parts(tree["opt_state"])
    assert set(adam) >= {"mu", "nu", "count"} and set(finite) >= {"notfinite_count", "last_finite"}
    assert "inner_state" in tree["opt_state"]  # the JAX trainer's layout


def test_checkpoint_is_served_and_read_by_the_jax_model(run1):
    out, state = run1
    ckpt = sorted((out / "checkpoints").glob("epoch_*"))[-1]
    synth = load_synthesizer(str(ckpt), device="cpu", text_buckets=(16, 32),
                             mel_fine_buckets=(64, 128))
    got = synth.model.state_dict()
    for name, p in state.params.items():
        assert torch.equal(got[name], p.detach()), name

    tree, _ = load_checkpoint(ckpt)
    rng = np.random.default_rng(0)
    batch = (rng.integers(0, 600, (2, 8)).astype(np.int32), np.asarray([8, 6], np.int32),
             rng.standard_normal((2, 12, CFG.n_feats)).astype(np.float32), np.asarray([12, 9], np.int32),
             rng.standard_normal((2, 24, CFG.n_feats)).astype(np.float32), np.asarray([24, 18], np.int32),
             np.asarray([0, 1], np.int32))
    losses = JaxMatchaTTS(jax_tiny_config()).apply(
        {"params": tree["params"]}, *batch, jax.random.PRNGKey(0), deterministic=True,
        method=JaxMatchaTTS.compute_losses)
    assert np.isfinite(float(losses["loss"]))


def test_resume_continues_the_step_count(corpus, run1):
    out, _ = run1
    ckpt = sorted((out / "checkpoints").glob("epoch_*"))[-1]
    trainer = make_trainer(corpus, "run2")
    try:
        resumed = trainer.init_state(str(ckpt))
        assert resumed.step == 3 and int(resumed.opt_state.count) == 3
        state = trainer.fit(resume_from=str(ckpt), max_steps=5)
    finally:
        trainer.close()
    assert state.step == 5


def test_tensor_parallel_raises(corpus):
    """tensor_parallel=2 without a process group raises: it never trains
    as one process (tests/test_torch_tensor_parallel.py trains it)."""
    with pytest.raises(RuntimeError, match="process group"):
        make_trainer(corpus, "run3", tensor_parallel=2)


def test_samplers_are_the_data_module_s(corpus):
    trainer = make_trainer(corpus, "run4")
    try:
        assert trainer.sampler is trainer.dm.train_sampler
        assert trainer.valid_sampler is trainer.dm.valid_sampler
        assert trainer.sampler.batch_multiple == 1 and not trainer.data_parallel
    finally:
        trainer.close()


def test_context_manager_closes_the_sinks(corpus):
    with make_trainer(corpus, "run5") as trainer:
        trainer.fit(max_steps=1)
        jsonl = trainer.logger.jsonl
        assert not jsonl.closed
    assert jsonl.closed and not mesh.active()
