"""Port parity: checkpoint surgery and the trainer's resume rule against the
JAX package's ``matcha_tpu/train/checkpoint.py`` and trainer.

The trees are ones the port wrote (``save_checkpoint`` of a tiny training
state with random Adam moments, read back by ``load_checkpoint``); the JAX
functions walk the same nested dicts.  Every comparison is exact: the
surgery copies, concatenates zero rows and averages in float64 with the
same formulas.
"""

import numpy as np
import pytest
import torch

from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.train import checkpoint as jax_ckpt
from matcha_tpu_torch.checkpoint import load_checkpoint, load_synthesizer
from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.finetune_speaker import trainable_mask_for_speaker
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.train import checkpoint as port_ckpt
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.step import TrainStep
from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig
from matcha_tpu_torch.utils import average_checkpoints as avg_cli
from matcha_tpu_torch.utils import prepare_ckpt_for_release as release_cli
from matcha_tpu_torch.weights import flatten_tree, params_from_jax

CFG = tiny_config(n_spks=4)
TABLES = ("speaker_embeddings_enc", "speaker_embeddings_dur")


def write_ckpt(path, seed, step=3):
    ts = TrainStep(CFG, OptimizerConfig(), device="cpu")
    state = ts.init_state(generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    for moments in (state.opt_state.mu, state.opt_state.nu):
        for n, t in moments.items():
            moments[n] = torch.rand(t.shape, generator=gen)
    state.opt_state.count.fill_(step)
    port_ckpt.save_checkpoint(path, state.params, state.opt_state, step, 1, CFG)
    return path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchsurgery")
    return [write_ckpt(root / f"ckpt{i}", seed=i) for i in range(3)]


def assert_trees_equal(got, want):
    fg, fw = flatten_tree(got), flatten_tree(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        g, w = np.asarray(fg[k]), np.asarray(fw[k])
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), k


def test_save_tree_round_trip(ckpts, tmp_path):
    tree, cfg = load_checkpoint(ckpts[0])
    port_ckpt.save_tree(tmp_path / "copy", tree, cfg)
    again, cfg2 = load_checkpoint(tmp_path / "copy")
    assert_trees_equal(again, tree)
    assert cfg2.to_dict() == cfg.to_dict()


def test_expand_speaker_tables(ckpts):
    tree, cfg = load_checkpoint(ckpts[0])
    before = {k: np.array(v) for k, v in flatten_tree(tree).items()}
    got, got_cfg = port_ckpt.expand_speaker_tables(tree, cfg, 7)
    want, want_cfg = jax_ckpt.expand_speaker_tables(tree, jax_tiny_config(n_spks=4), 7)
    assert got_cfg.n_spks == want_cfg.n_spks == 7
    assert_trees_equal(got, want)
    for part in ("mu", "nu"):  # the moments grow with zero rows
        table = got["opt_state"][part]["speaker_embeddings_enc"]["embedding"]
        assert table.shape == (7, CFG.spk_emb_dim) and not table[4:].any() and table[:4].any()
    assert int(got["opt_state"]["count"]) == 3
    assert_trees_equal(tree, before)  # the input is untouched
    assert port_ckpt.expand_speaker_tables(tree, cfg, 4)[1] is cfg


def test_add_speaker_rows(ckpts):
    tree, cfg = load_checkpoint(ckpts[1])
    rng = np.random.default_rng(0)
    enc, dur = rng.standard_normal((2, CFG.spk_emb_dim)).astype(np.float32)
    got, got_cfg = port_ckpt.add_speaker_rows(tree, cfg, enc, dur)
    want, want_cfg = jax_ckpt.add_speaker_rows(tree, jax_tiny_config(n_spks=4), enc, dur)
    assert got_cfg.n_spks == want_cfg.n_spks == 5
    assert_trees_equal(got, want)
    assert np.array_equal(got["params"]["speaker_embeddings_dur"]["embedding"][-1], dur)
    assert tree["params"]["speaker_embeddings_enc"]["embedding"].shape[0] == 4


def test_transplant_speaker(ckpts):
    dst, _ = load_checkpoint(ckpts[0])
    src, _ = load_checkpoint(ckpts[1])
    got = port_ckpt.transplant_speaker(dst, src, dst_id=2, src_id=3)
    want = jax_ckpt.transplant_speaker(load_checkpoint(ckpts[0])[0], src, dst_id=2, src_id=3)
    assert_trees_equal(got, want)
    for name in TABLES:
        assert np.array_equal(got["params"][name]["embedding"][2], src["params"][name]["embedding"][3])
        assert not np.array_equal(dst["params"][name]["embedding"][2], src["params"][name]["embedding"][3])


def test_average_and_strip(ckpts):
    trees = [load_checkpoint(p)[0] for p in ckpts]
    got = port_ckpt.average_checkpoints(trees)
    assert_trees_equal(got, jax_ckpt.average_checkpoints(trees))
    assert_trees_equal(port_ckpt.strip_for_release(got), jax_ckpt.strip_for_release(got))
    assert set(port_ckpt.strip_for_release(got)) == {"params", "step"}


def test_average_and_release_clis(ckpts, tmp_path):
    avg_cli.main(["--inputs", *map(str, ckpts), "--output", str(tmp_path / "avg")])
    got, cfg = load_checkpoint(tmp_path / "avg")
    assert_trees_equal(got, port_ckpt.average_checkpoints([load_checkpoint(p)[0] for p in ckpts]))
    release_cli.main(["--input", str(tmp_path / "avg"), "--output", str(tmp_path / "release")])
    stripped, cfg2 = load_checkpoint(tmp_path / "release")
    assert set(stripped) == {"params", "step"} and cfg2.to_dict() == cfg.to_dict()
    assert_trees_equal(stripped["params"], got["params"])
    synth = load_synthesizer(str(tmp_path / "release"), device="cpu", text_buckets=(16,),
                             mel_fine_buckets=(64,))
    assert synth.model.speaker_embeddings_enc.weight.shape == (4, CFG.spk_emb_dim)


# -- the trainer's resume rule ------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchsurgerycorpus")
    mel_dir = root / "mels"
    mel_dir.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        frames = int(rng.integers(12, 30))
        np.save(mel_dir / f"u{i}.npy", rng.standard_normal((CFG.n_feats, frames)).astype(np.float32))
        np.save(mel_dir / f"u{i}.fine.npy", rng.standard_normal((CFG.n_feats, 2 * frames)).astype(np.float32))
        ids = " ".join(str(v) for v in rng.integers(0, 600, 8))
        rows.append(f"u{i}|{i % 4}|en-us|text {i}|{ids}")
    filelist = root / "train.csv"
    filelist.write_text("\n".join(rows))
    return root, TextMelDataset(filelist, mel_dir, n_feats=CFG.n_feats)


def make_trainer(corpus, n_spks, name, trainable_mask=None):
    root, ds = corpus
    cfg = tiny_config(n_spks=n_spks)
    tcfg = TrainerConfig(output_dir=str(root / name), log_every_n_steps=1,
                         checkpoint_every_n_epochs=100)
    return Trainer(cfg, OptimizerConfig(lr=1e-3), tcfg, ds, max_frames_per_batch=256,
                   len_bucket=16, text_bucket=16, trainable_mask=trainable_mask, device="cpu")


def test_resume_with_more_speakers_expands_tables_and_moments(corpus, ckpts):
    tree, _ = load_checkpoint(ckpts[2])
    want, _ = jax_ckpt.expand_speaker_tables(tree, jax_tiny_config(n_spks=4), 6)
    cfg6 = tiny_config(n_spks=6)
    trainer = make_trainer(corpus, 6, "resume6")
    try:
        state = trainer.init_state(str(ckpts[2]))
        assert state.step == 3 and int(state.opt_state.count) == 3
        for got, subtree in ((state.params, want["params"]), (state.opt_state.mu, want["opt_state"]["mu"]),
                             (state.opt_state.nu, want["opt_state"]["nu"])):
            ref = params_from_jax(subtree, cfg6)
            for name in ref:
                assert torch.equal(got[name].detach(), ref[name]), name
        state = trainer.fit(resume_from=str(ckpts[2]), max_steps=4)
    finally:
        trainer.close()
    assert state.step == 4 and state.params["speaker_embeddings_enc.weight"].shape[0] == 6


def test_resume_with_fewer_speakers_raises(corpus, ckpts):
    trainer = make_trainer(corpus, 2, "resume2")
    try:
        with pytest.raises(ValueError, match="shrinking"):
            trainer.init_state(str(ckpts[0]))
    finally:
        trainer.close()


def test_fine_tune_resume_needs_equal_counts(corpus, ckpts):
    trainer = make_trainer(corpus, 6, "finetune6", trainable_mask_for_speaker(tiny_config(n_spks=6)))
    try:
        with pytest.raises(ValueError, match="data.n_spks=4"):
            trainer.init_state(str(ckpts[0]))
    finally:
        trainer.close()
