"""Port parity: speaker fine-tuning and add-speaker against the JAX package.

* ``trainable_mask_for_speaker``: the port's mask, by parameter name,
  equals the JAX mask mapped through the weight table.
* One masked training step against the JAX package's loss + optax chain
  with the trainable mask, deterministic, CFM's (t, noise) passed in, at
  the tolerance and Adam eps of ``tests/test_torch_train_step.py`` (1e-5,
  eps 1e-3; see there).  On the port side, frozen parameters and
  non-target table rows are bitwise unchanged.
* The ``finetune_speaker`` CLI end to end on the CPU: same freezing,
  checked on the checkpoint it writes.
* ``add_speaker``: both CLIs on the same recordings, checkpoint weights and
  style pickle; the appended rows agree within 1e-4 (fp32 mels from two
  FFT libraries through four convs), every other row is equal, ``n_spks``
  grows by one, and the port serves the new speaker.
"""

import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matcha_tpu import add_speaker as jax_add_speaker
from matcha_tpu.finetune_speaker import trainable_mask_for_speaker as jax_trainable_mask
from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import MatchaTTS as JaxMatchaTTS
from matcha_tpu.models.matcha import init_params
from matcha_tpu.models.style_encoder import init_style_params as jax_init_style_params
from matcha_tpu.train import checkpoint as jax_ckpt
from matcha_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from matcha_tpu.train.optim import build_optimizer
from matcha_tpu.utils.audio_io import read_wav, write_wav
from matcha_tpu_torch import add_speaker, finetune_speaker
from matcha_tpu_torch.checkpoint import load_checkpoint, load_synthesizer
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.train.checkpoint import save_tree
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.step import Batch, TrainStep
from matcha_tpu_torch.weights import flatten_tree, matcha_param_table, params_from_jax, params_to_jax

CFG = tiny_config()
FIXTURES = Path(__file__).resolve().parent.parent / "mcd_validation"
TARGET = 2
TABLES = ("speaker_embeddings_enc.weight", "speaker_embeddings_dur.weight")


@pytest.fixture(scope="module")
def params():
    init = jax.jit(lambda key: init_params(jax_tiny_config(), key))
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    # the FiLM projection starts at identity, where logw ignores the
    # duration table: give it weights so that table's target row trains
    proj = tree["encoder"]["proj_w"]["spk_proj"]
    proj["kernel"] = (np.random.default_rng(7).standard_normal(proj["kernel"].shape) * 0.3).astype(np.float32)
    return tree


def test_mask_matches_jax_by_name(params):
    want = flatten_tree(jax_trainable_mask(params))
    got = finetune_speaker.trainable_mask_for_speaker(CFG)
    rows = matcha_param_table(CFG)
    assert set(got) == {r[0] for r in rows}
    for name, flax_path, _ in rows:
        assert got[name] == bool(want[flax_path]), name
    assert sorted(n for n, m in got.items() if m) == sorted(TABLES)


def make_batch(seed=0, b=3, tx=10, ty=12):
    rng = np.random.default_rng(seed)
    y_lengths = rng.integers(8, ty + 1, (b,)).astype(np.int32)
    return (
        rng.integers(0, 600, (b, tx)).astype(np.int32),
        rng.integers(4, tx + 1, (b,)).astype(np.int32),
        rng.standard_normal((b, ty, CFG.n_feats)).astype(np.float32),
        y_lengths,
        rng.standard_normal((b, 2 * ty, CFG.n_feats)).astype(np.float32),
        (2 * y_lengths).astype(np.int32),
        np.full((b,), TARGET, np.int32),
    )


def test_one_masked_step_matches_jax(params):
    batch = make_batch(4)
    rng = np.random.default_rng(9)
    t = rng.uniform(0.05, 0.95, (3, 1, 1)).astype(np.float32)
    noise = rng.standard_normal((3, 12, CFG.n_feats)).astype(np.float32)

    model = JaxMatchaTTS(jax_tiny_config())
    tx = build_optimizer(JaxOptimizerConfig(lr=1e-3, eps=1e-3), trainable_mask=jax_trainable_mask(params))

    def loss_fn(p):
        out = model.apply({"params": p}, *map(jnp.asarray, batch), jax.random.PRNGKey(0),
                          deterministic=True, cfm_t_noise=(jnp.asarray(t), jnp.asarray(noise)),
                          method=JaxMatchaTTS.compute_losses)
        return out["loss"], out

    jp = jax.tree.map(jnp.asarray, params)
    (_, jl), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    updates, _ = tx.update(grads, tx.init(jp), jp)
    want = flatten_tree(jax.tree.map(np.asarray, optax.apply_updates(jp, updates)))

    ts = TrainStep(CFG, OptimizerConfig(lr=1e-3, eps=1e-3), device="cpu",
                   trainable=finetune_speaker.trainable_mask_for_speaker(CFG))
    state = ts.init_state(params_from_jax(params, CFG))
    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, metrics = ts.train_step(
        state, Batch(*map(torch.from_numpy, batch)), seed=0,
        deterministic=True, cfm_t_noise=(torch.from_numpy(t), torch.from_numpy(noise)))
    got = flatten_tree(params_to_jax(state.params, CFG))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(grads)), rtol=1e-5)
    for name, p in state.params.items():
        if name in TABLES:
            others = [i for i in range(CFG.n_spks) if i != TARGET]
            assert torch.equal(p.detach()[others], before[name][others]), name
            assert not torch.equal(p.detach()[TARGET], before[name][TARGET]), name
        else:
            assert torch.equal(p.detach(), before[name]), name


def write_corpus(root: Path, n_spks: int):
    mel_dir = root / "mels"
    mel_dir.mkdir(parents=True)
    rng = np.random.default_rng(1)
    rows = []
    for i in range(8):
        frames = int(rng.integers(10, 20))
        np.save(mel_dir / f"u{i}.npy", rng.standard_normal((CFG.n_feats, frames)).astype(np.float32))
        np.save(mel_dir / f"u{i}.fine.npy", rng.standard_normal((CFG.n_feats, 2 * frames)).astype(np.float32))
        rows.append(f"u{i}|{i % n_spks}|en-us|t|" + " ".join(str(v) for v in rng.integers(1, 600, 7)))
    (mel_dir / "metadata.json").write_text(json.dumps({"n_mels": CFG.n_feats}))
    (root / "train.csv").write_text("\n".join(rows))
    return root / "train.csv", mel_dir


def test_finetune_cli_moves_only_the_target_rows(params, tmp_path):
    save_tree(tmp_path / "ckpt", {"params": params, "step": np.asarray(0)}, CFG)
    filelist, mel_dir = write_corpus(tmp_path, CFG.n_spks)
    config = {"model": CFG.to_dict(),
              "data": {"train_filelist_path": str(filelist), "mel_dir": str(mel_dir),
                       "max_frames_per_batch": 64, "len_bucket": 8, "text_bucket": 8},
              "trainer": {"max_epochs": 2, "checkpoint_every_n_epochs": 1},
              "optimizer": {"lr": 1e-2}, "paths": {"output_dir": str(tmp_path / "out")}, "seed": 3}
    (tmp_path / "cfg.yaml").write_text(json.dumps(config))
    state = finetune_speaker.main(["--config", str(tmp_path / "cfg.yaml"), "--target_speaker", str(TARGET),
                                   "--device", "cpu", f"ckpt_path={tmp_path / 'ckpt'}"])
    assert state.step > 0
    ckpt = sorted((tmp_path / "out" / "checkpoints").glob("epoch_*"))[-1]
    tree, cfg = load_checkpoint(ckpt)
    assert cfg.n_spks == CFG.n_spks
    got, start = flatten_tree(tree["params"]), flatten_tree(params)
    for k, v in start.items():
        if k.startswith("speaker_embeddings"):
            others = [i for i in range(CFG.n_spks) if i != TARGET]
            assert np.array_equal(got[k][others], v[others]), k
            assert not np.array_equal(got[k][TARGET], v[TARGET]), k
        else:
            assert np.array_equal(got[k], v), k
    with pytest.raises(SystemExit, match="No utterances"):
        finetune_speaker.main(["--config", str(tmp_path / "cfg.yaml"), "--target_speaker", "9",
                               "--device", "cpu", f"ckpt_path={tmp_path / 'ckpt'}"])


@pytest.fixture(scope="module")
def speaker_inputs(params, tmp_path_factory):
    root = tmp_path_factory.mktemp("torchaddspeaker")
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    for i, n in enumerate((12000, 17000)):
        wav, sr = read_wav(FIXTURES / f"original_speaker_00{i + 3}.wav")
        write_wav(wav_dir / f"clip{i}.wav", wav[:n], sr)
    style = jax.tree.map(np.asarray, jax_init_style_params(jax_tiny_config(), jax.random.PRNGKey(3)))
    with open(root / "style_params.pkl", "wb") as f:
        pickle.dump(style, f)
    tree = {"params": params, "step": np.asarray(0)}
    jax_ckpt.save_checkpoint(root / "jax_ckpt", tree, jax_tiny_config())
    save_tree(root / "port_ckpt", tree, CFG)
    return root


def test_add_speaker_matches_jax_cli(speaker_inputs, params):
    root = speaker_inputs
    common = ["--style_params", str(root / "style_params.pkl"), "--wav_dir", str(root / "wavs")]
    jax_add_speaker.main(["--checkpoint_path", str(root / "jax_ckpt"), "--output", str(root / "jax_out"),
                          *common])
    add_speaker.main(["--checkpoint_path", str(root / "port_ckpt"), "--output", str(root / "port_out"),
                      "--device", "cpu", *common])
    want_tree, want_cfg = jax_ckpt.load_checkpoint(root / "jax_out")
    got_tree, got_cfg = load_checkpoint(root / "port_out")
    assert got_cfg.n_spks == want_cfg.n_spks == CFG.n_spks + 1
    for name in ("speaker_embeddings_enc", "speaker_embeddings_dur"):
        got = got_tree["params"][name]["embedding"]
        want = np.asarray(want_tree["params"][name]["embedding"])
        assert got.shape == want.shape == (CFG.n_spks + 1, CFG.spk_emb_dim)
        assert np.array_equal(got[:-1], params[name]["embedding"])
        assert np.abs(got[-1] - want[-1]).max() <= 1e-4, name
        assert np.abs(got[-1]).max() > 0

    synth = load_synthesizer(str(root / "port_out"), device="cpu", text_buckets=(16,),
                             mel_fine_buckets=(64,))
    res = synth.synthesise_ids(list(range(1, 9)), speaker=CFG.n_spks, debug=True)
    assert res.mel is not None and res.mel.shape[1] == CFG.n_feats and np.isfinite(res.mel).all()
