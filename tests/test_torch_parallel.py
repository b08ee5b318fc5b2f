"""Data-parallel training on the CPU: world 2 over gloo against one process.

Two processes (``torch.multiprocessing`` spawn, a file store in
``tmp_path``) each take a contiguous block of a batch whose rows have
unequal text and mel lengths and whose last row is repeat-filled (loss
weight 0), so the per-rank frame counts differ.  At dropout 0:

  * one ``TrainStep``: the gradients every rank hands the optimizer equal
    the single process's on the whole batch to 1e-5 (max|err| / max|ref|
    per parameter: fp32 sums in another order); the losses to 1e-5
    relative; the parameters after the step to 1e-5 absolute at Adam eps
    1e-3 (as ``tests/test_torch_train_step.py``); and bit-identical across
    ranks;
  * two ``Trainer`` steps (the trainer starts the group from ``WORLD_SIZE``
    and ends it on exit): the same against a single-process ``Trainer``,
    with only rank 0 writing the checkpoint;
  * the normalization matters: the mean of per-rank mean losses, as a
    gradient-averaging wrapper would compute them, misses the global loss.

No JAX here: the spawned workers import this module.  TensorBoard is kept
out (its import takes seconds and none of this tests it): the trainers log
to JSONL alone.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.matcha import init_params
from matcha_tpu_torch.parallel import mesh
from matcha_tpu_torch.train import trainer as trainer_module
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.step import Batch, TrainStep
from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig

WORLD = 2
B, TX, TY = 4, 12, 16
OPT = OptimizerConfig(lr=1e-3, eps=1e-3)


def no_dropout(cfg):
    return dataclasses.replace(
        cfg,
        encoder=dataclasses.replace(cfg.encoder, p_dropout=0.0),
        duration_predictor=dataclasses.replace(cfg.duration_predictor, p_dropout=0.0),
        decoder=dataclasses.replace(cfg.decoder, dropout=0.0),
    )


CFG = no_dropout(tiny_config())


def global_batch() -> Batch:
    """Rows of unequal lengths; row 3 repeats row 0 with weight 0, so rank 0
    holds 2 weighted rows of long utterances and rank 1 one short one."""
    rng = np.random.default_rng(11)
    x_lengths = np.asarray([12, 10, 5, 12], np.int32)
    y_lengths = np.asarray([16, 14, 7, 16], np.int32)
    x = rng.integers(1, 600, (B, TX)).astype(np.int32)
    y = rng.standard_normal((B, TY, CFG.n_feats)).astype(np.float32)
    y_fine = rng.standard_normal((B, 2 * TY, CFG.n_feats)).astype(np.float32)
    x[3], y[3], y_fine[3] = x[0], y[0], y_fine[0]
    spks = np.asarray([0, 1, 2, 0], np.int32)
    weights = np.asarray([1, 1, 1, 0], np.float32)
    return Batch(*map(torch.from_numpy, (x, x_lengths, y, y_lengths, y_fine, 2 * y_lengths, spks, weights)))


def one_step(ts: TrainStep, batch: Batch):
    """One step with the optimizer's input gradients recorded."""
    seen = {}
    real = ts.opt.update

    def spy(params, grads, state):
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        real(params, grads, state)

    ts.opt.update = spy
    state = ts.init_state(init_params(CFG, torch.Generator().manual_seed(0)))
    state, metrics = ts.train_step(state, batch, seed=3)
    return seen, {n: p.detach() for n, p in state.params.items()}, {k: float(v) for k, v in metrics.items()}


def step_worker(rank, init_file, out):
    torch.set_num_threads(1)
    mesh.init_data_parallel("cpu", init_method=f"file://{init_file}", rank=rank, world_size=WORLD)
    try:
        batch = mesh.shard_rows(global_batch(), rank, WORLD)
        grads, params, metrics = one_step(TrainStep(CFG, OPT, device="cpu", data_parallel=True), batch)
        torch.save({"grads": grads, "params": params, "metrics": metrics}, f"{out}/rank{rank}.pt")
    finally:
        mesh.destroy()


def spawn(fn, *args):
    mp.start_processes(fn, args=args, nprocs=WORLD, join=True, start_method="spawn")


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def test_train_step_world2_equals_one_process(tmp_path):
    spawn(step_worker, str(tmp_path / "store"), str(tmp_path))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    grads, params, metrics = one_step(TrainStep(CFG, OPT, device="cpu"), global_batch())
    for name, g in grads.items():
        assert rel_err(ranks[0]["grads"][name], g) <= 1e-5, name
        torch.testing.assert_close(ranks[0]["params"][name], params[name], rtol=0, atol=1e-5)
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name
    for k in ("loss", "sub_loss/diff", "sub_loss/dur", "sub_loss/prior", "grad_norm"):
        assert ranks[0]["metrics"][k] == ranks[1]["metrics"][k]
        assert abs(ranks[0]["metrics"][k] - metrics[k]) <= 1e-5 * abs(metrics[k]), k


def test_mean_of_rank_means_misses_the_global_loss():
    """A wrapper that averages per-rank mean losses (DDP's gradient mean)
    normalizes each rank by its own frame count: on this batch that is a
    different loss, so the test batch exercises the global normalization."""
    ts = TrainStep(CFG, OPT, device="cpu")
    state = ts.init_state(init_params(CFG, torch.Generator().manual_seed(0)))
    whole = global_batch()

    def losses(batch):
        with torch.no_grad():
            return ts.eval_step(state.params, batch, seed=3, deterministic=True)

    full = losses(whole)
    per_rank = [losses(mesh.shard_rows(whole, r, WORLD)) for r in range(WORLD)]
    for k in ("sub_loss/dur", "sub_loss/prior"):
        naive = sum(float(m[k]) for m in per_rank) / WORLD
        assert abs(naive - float(full[k])) > 1e-2 * abs(float(full[k])), k


# -- the Trainer ----------------------------------------------------------------

def write_corpus(root) -> None:
    """12 utterances of 17-32 coarse frames: bucket 32, 8 rows a batch, so a
    world of 2 leaves the plans as one process makes them; the second plan
    has 4 real rows and 4 repeat-filled ones."""
    mel_dir = root / "mels"
    mel_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(12):
        frames = int(rng.integers(17, 33))
        np.save(mel_dir / f"u{i}.npy", rng.standard_normal((CFG.n_feats, frames)).astype(np.float32))
        np.save(mel_dir / f"u{i}.fine.npy", rng.standard_normal((CFG.n_feats, 2 * frames)).astype(np.float32))
        ids = " ".join(str(v) for v in rng.integers(1, 600, rng.integers(4, 15)))
        rows.append(f"u{i}|{i % CFG.n_spks}|en-us|text {i}|{ids}")
    (root / "train.csv").write_text("\n".join(rows))


def make_trainer(root, **kw):
    tcfg = TrainerConfig(output_dir=str(root / "run"), log_every_n_steps=1, checkpoint_every_n_epochs=100,
                         **kw)
    return Trainer(CFG, OPT, tcfg, TextMelDataset(root / "train.csv", root / "mels", n_feats=CFG.n_feats),
                   max_frames_per_batch=256, len_bucket=16, text_bucket=16, device="cpu")


def trainer_worker(rank, root, init_file):
    import os
    import sys
    from pathlib import Path

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank))
    saves = []
    real_save = trainer_module.save_checkpoint

    def counted_save(*args, **kwargs):
        saves.append(args[0])
        real_save(*args, **kwargs)

    trainer_module.save_checkpoint = counted_save
    with make_trainer(Path(root), dist_init_method=f"file://{init_file}") as trainer:
        started = mesh.active() and trainer.data_parallel and trainer.world == WORLD
        shapes = []
        real_step = trainer.train_step

        def step(state, batch, seed):
            shapes.append(list(batch.y.shape[:2]))
            return real_step(state, batch, seed)

        trainer.train_step = step
        state = trainer.fit(max_steps=2)
        multiple = trainer.sampler.batch_multiple
    torch.save({"params": {n: p.detach() for n, p in state.params.items()}, "started": started,
                "ended": not mesh.active(), "saves": len(saves), "shapes": shapes, "multiple": multiple},
               Path(root) / f"trainer{rank}.pt")


def test_trainer_world2_equals_one_process(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    write_corpus(tmp_path)
    spawn(trainer_worker, str(tmp_path), str(tmp_path / "store"))
    ranks = [torch.load(tmp_path / f"trainer{r}.pt") for r in range(WORLD)]
    assert all(r["started"] and r["ended"] and r["multiple"] == WORLD for r in ranks)
    assert ranks[0]["saves"] == 1 and ranks[1]["saves"] == 0
    assert ranks[0]["shapes"] == ranks[1]["shapes"] == [[4, 32], [4, 32]]
    recs = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    dp_losses = [r["loss"] for r in recs if "loss" in r]

    single_root = tmp_path / "single"
    single_root.mkdir()
    (single_root / "train.csv").symlink_to(tmp_path / "train.csv")
    (single_root / "mels").symlink_to(tmp_path / "mels")
    with make_trainer(single_root) as trainer:
        assert not trainer.data_parallel
        state = trainer.fit(max_steps=2)
    recs = [json.loads(line) for line in open(single_root / "run" / "metrics.jsonl")]
    single_losses = [r["loss"] for r in recs if "loss" in r]
    np.testing.assert_allclose(dp_losses, single_losses, rtol=1e-5)
    for name, p in state.params.items():
        torch.testing.assert_close(ranks[0]["params"][name], p.detach(), rtol=0, atol=1e-5)
        assert torch.equal(ranks[0]["params"][name], ranks[1]["params"][name]), name
    assert len(list((tmp_path / "run" / "checkpoints").glob("epoch_*"))) == 1


@pytest.mark.parametrize("n_rows,rank,world,want", [(8, 0, 2, slice(0, 4)), (8, 1, 2, slice(4, 8)),
                                                    (6, 2, 3, slice(4, 6))])
def test_shard_rows_takes_contiguous_blocks(n_rows, rank, world, want):
    assert mesh.row_block(n_rows, rank, world) == want
    batch = global_batch()._replace(weights=None)
    block = mesh.shard_rows(batch, 1, 2)
    assert isinstance(block, Batch) and block.weights is None
    assert torch.equal(block.x, batch.x[2:]) and torch.equal(mesh.shard_rows(batch.y, 0, 2), batch.y[:2])


def test_shard_rows_needs_divisible_batches():
    with pytest.raises(ValueError):
        mesh.row_block(5, 0, 2)


def test_without_a_group_the_helpers_are_single_process():
    assert not mesh.active() and mesh.world() == 1 and mesh.rank() == 0
    t = torch.arange(3.0)
    assert torch.equal(mesh.all_reduce_sum(t), t)
    with pytest.raises(RuntimeError, match="process group"):
        TrainStep(CFG, OPT, device="cpu", data_parallel=True)


def test_cli_pins_each_torchrun_rank_to_its_card(monkeypatch):
    from matcha_tpu_torch.train.__main__ import default_device

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert default_device() is None
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert default_device() == "cuda:3"


def test_a_failed_group_start_raises(tmp_path, monkeypatch):
    """use_mesh with WORLD_SIZE > 1 never falls back to one process."""
    write_corpus(tmp_path)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="rendezvous"):
        make_trainer(tmp_path, dist_init_method="unknown-scheme://nowhere")
    assert not mesh.active()
