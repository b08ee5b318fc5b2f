"""Port parity: the StyleEncoder, its loss against the frozen encoder, its
optimizer, the ``style_params.pkl`` bridge and the training CLI.

Same bridged weights (JAX ``init_params`` / ``init_style_params`` at
``tiny_config()``) and the same numpy batch through both packages.
Tolerances: forward 1e-5; the loss and its two parts 1e-5 relative (fp32
through two encoder passes); each gradient leaf as max|err| / max|ref|:
at beta 1, 1e-5 against JAX; at the tool's betas (0.002 / 0.004) 2e-5,
against JAX and, for both packages, against the port run in float64: the
smooth-L1 gradient inside |x| < beta is x / beta, so the encoder's fp32
rounding reaches the gradient 250-500 times larger in either package
(measured: port 1.29e-5 and JAX 2.7e-6 from float64, port against JAX
1.16e-5; at beta 1 all three ~1.5e-6); one optimizer step on fixed
gradients
against ``optax.chain(clip_by_global_norm(4.0), optax.adamw(lr))`` 1e-6;
the pickle bridge exact.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import init_params
from matcha_tpu.models.style_encoder import StyleEncoder as JaxStyleEncoder
from matcha_tpu.models.style_encoder import init_style_params as jax_init_style_params
from matcha_tpu.models.style_encoder import style_encoder_loss as jax_style_encoder_loss
from matcha_tpu.train.step import Batch as JaxBatch
from matcha_tpu_torch import train_style_encoder
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.models.style_encoder import StyleEncoder, init_style_params, style_encoder_loss
from matcha_tpu_torch.models.text_encoder import TextEncoder
from matcha_tpu_torch.text.symbols import N_VOCAB
from matcha_tpu_torch.train.checkpoint import save_tree
from matcha_tpu_torch.train.step import Batch
from matcha_tpu_torch.weights import (
    flatten_tree,
    params_from_jax,
    style_params_from_jax,
    style_params_to_jax,
)

CFG = tiny_config()
B, TX, TY = 3, 9, 14


@pytest.fixture(scope="module")
def weights():
    init = jax.jit(lambda key: init_params(jax_tiny_config(), key))
    matcha = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))
    # the FiLM projection starts at identity, where logw ignores the
    # duration embedding: give it weights so the rhythm loss reaches pred_dur
    kernel = matcha["encoder"]["proj_w"]["spk_proj"]["kernel"]
    matcha["encoder"]["proj_w"]["spk_proj"]["kernel"] = (
        np.random.default_rng(7).standard_normal(kernel.shape) * 0.3).astype(np.float32)
    style = jax.tree.map(np.asarray, jax_init_style_params(jax_tiny_config(), jax.random.PRNGKey(1)))
    return matcha, style


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    y_lengths = np.array([TY, TY - 3, 8], np.int32)
    return (
        rng.integers(0, 600, (B, TX)).astype(np.int32),
        np.array([TX, 6, 4], np.int32),
        rng.standard_normal((B, TY, CFG.n_feats)).astype(np.float32),
        y_lengths,
        rng.standard_normal((B, 2 * TY, CFG.n_feats)).astype(np.float32),
        (2 * y_lengths).astype(np.int32),
        np.array([0, 3, 1], np.int32),
    )


def port_modules(weights, dtype=torch.float32):
    """The frozen model and the StyleEncoder; with ``dtype=torch.float64``
    the encoder and the StyleEncoder compute in float64 (the reference)."""
    matcha, style_tree = weights
    model = MatchaTTS(CFG)
    model.load_state_dict(params_from_jax(matcha, CFG))
    if dtype == torch.float64:
        encoder = TextEncoder(CFG.encoder, CFG.duration_predictor, N_VOCAB, CFG.spk_emb_dim, dtype=dtype)
        encoder.load_state_dict(model.encoder.state_dict())
        model.encoder = encoder
    model.eval().requires_grad_(False)
    style = StyleEncoder(CFG.n_feats, CFG.spk_emb_dim, dtype=dtype)
    style.load_state_dict(style_params_from_jax(style_tree))
    return model, style


def jax_loss_and_grads(weights, batch, **betas):
    matcha, style_tree = weights
    jb = JaxBatch(*map(jnp.asarray, batch))
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_style_encoder_loss(p, matcha, jax_tiny_config(), jb, **betas), has_aux=True))(style_tree)
    return loss, parts, flatten_tree(jax.tree.map(np.asarray, grads))


def port_loss_and_grads(weights, batch, dtype=torch.float32, **betas):
    model, style = port_modules(weights, dtype)
    loss, parts = style_encoder_loss(style, model, Batch(*map(torch.from_numpy, batch)), **betas)
    params = dict(style.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert all(not p.requires_grad for p in model.parameters())
    return loss.detach(), parts, flatten_tree(style_params_to_jax(dict(zip(params, grads))))


def rel_errors(got, want):
    """Per leaf: max |got − want| / max |want|."""
    assert sorted(got) == sorted(want)
    return {k: np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-12) for k in want}


def test_forward_matches(weights):
    _, style_tree = weights
    _, style = port_modules(weights)
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((2, 17, CFG.n_feats)).astype(np.float32)
    mask = np.ones((2, 17), np.float32)
    mask[1, 11:] = 0.0
    want = JaxStyleEncoder(spk_emb_dim=CFG.spk_emb_dim).apply({"params": style_tree}, mel, mask)
    with torch.no_grad():
        got = style(torch.from_numpy(mel), torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert g.shape == (2, CFG.spk_emb_dim)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    # padding does not reach the pooled embedding
    mel2 = mel.copy()
    mel2[1, 11:] = 99.0
    with torch.no_grad():
        again = style(torch.from_numpy(mel2), torch.from_numpy(mask))
    torch.testing.assert_close(again[0], got[0], rtol=0, atol=1e-5)


def test_loss_and_gradients_match(weights):
    batch = make_batch()
    jax_loss, jax_parts, want = jax_loss_and_grads(weights, batch)
    loss, parts, got = port_loss_and_grads(weights, batch)

    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-5)
    for k in ("acoustic", "rhythm"):
        np.testing.assert_allclose(float(parts[k]), float(jax_parts[k]), rtol=1e-5)
    for k, err in rel_errors(got, want).items():
        assert err <= 2e-5, (k, err)
    assert float(np.abs(want["head_dur/kernel"]).max()) > 0.0  # the rhythm loss reaches pred_dur
    # the float64 reference: both packages' fp32 gradients stand as far from it
    _, _, exact = port_loss_and_grads(weights, batch, torch.float64)
    for name, grads in (("port", got), ("jax", want)):
        for k, err in rel_errors(grads, exact).items():
            assert err <= 2e-5, (name, k, err)


def test_gradients_match_at_unit_beta(weights):
    """At beta 1 the smooth-L1 gradient is x itself, and the port holds
    JAX's gradients to 1e-5."""
    batch = make_batch()
    betas = {"acoustic_beta": 1.0, "rhythm_beta": 1.0}
    jax_loss, _, want = jax_loss_and_grads(weights, batch, **betas)
    loss, _, got = port_loss_and_grads(weights, batch, **betas)
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-5)
    for k, err in rel_errors(got, want).items():
        assert err <= 1e-5, (k, err)
    assert float(np.abs(want["head_dur/kernel"]).max()) > 0.0


def test_one_optimizer_step_matches_optax(weights):
    _, style_tree = weights
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 3.0).astype(np.float32), style_tree)
    lr = 1e-3
    tx = optax.chain(optax.clip_by_global_norm(4.0), optax.adamw(lr))
    jp = jax.tree.map(jnp.asarray, style_tree)
    state = tx.init(jp)
    _, style = port_modules(weights)
    opt = train_style_encoder.style_optimizer(style, lr)
    params = dict(style.named_parameters())
    opt_state = opt.init(params)
    port_grads = style_params_from_jax(grads)
    for _ in range(2):
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(params, port_grads, opt_state)
    got = flatten_tree(style_params_to_jax(style.state_dict()))
    want = flatten_tree(jax.tree.map(np.asarray, jp))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_pickle_bridge_round_trips(weights, tmp_path):
    _, style_tree = weights
    back = style_params_to_jax(style_params_from_jax(style_tree))
    fw, fb = flatten_tree(style_tree), flatten_tree(back)
    assert sorted(fw) == sorted(fb)
    for k in fw:
        assert fb[k].shape == fw[k].shape and np.array_equal(fb[k], fw[k]), k
    state = init_style_params(CFG, torch.Generator().manual_seed(0))
    with open(tmp_path / "style_params.pkl", "wb") as f:
        pickle.dump(style_params_to_jax(state), f)
    with open(tmp_path / "style_params.pkl", "rb") as f:
        tree = pickle.load(f)
    assert tree["conv0"]["kernel"].shape == (5, CFG.n_feats, 256)
    assert tree["head_enc"]["kernel"].shape == (256, CFG.spk_emb_dim)
    for name, t in style_params_from_jax(tree).items():
        assert torch.equal(t, state[name]), name
    mel = np.random.default_rng(4).standard_normal((1, 10, CFG.n_feats)).astype(np.float32)
    want = JaxStyleEncoder(spk_emb_dim=CFG.spk_emb_dim).apply({"params": tree}, mel, np.ones((1, 10)))
    style = StyleEncoder(CFG.n_feats, CFG.spk_emb_dim)
    style.load_state_dict(state)
    with torch.no_grad():
        got = style(torch.from_numpy(mel), torch.ones(1, 10))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)


def test_training_cli_writes_pickle_and_metrics(weights, tmp_path):
    matcha, _ = weights
    save_tree(tmp_path / "ckpt", {"params": matcha, "step": np.asarray(0)}, CFG)
    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    rng = np.random.default_rng(5)
    rows = []
    for i in range(4):
        frames = int(rng.integers(10, 20))
        np.save(mel_dir / f"u{i}.npy", rng.standard_normal((CFG.n_feats, frames)).astype(np.float32))
        np.save(mel_dir / f"u{i}.fine.npy", rng.standard_normal((CFG.n_feats, 2 * frames)).astype(np.float32))
        rows.append(f"u{i}|{i % CFG.n_spks}|en-us|t|" + " ".join(str(v) for v in rng.integers(1, 600, 7)))
    (mel_dir / "metadata.json").write_text(json.dumps({"n_mels": CFG.n_feats}))
    (tmp_path / "train.csv").write_text("\n".join(rows))
    config = {"data": {"train_filelist_path": str(tmp_path / "train.csv"), "mel_dir": str(mel_dir),
                       "max_frames_per_batch": 64, "len_bucket": 8, "text_bucket": 8},
              "paths": {"output_dir": str(tmp_path / "out")}, "seed": 1}
    (tmp_path / "cfg.yaml").write_text(json.dumps(config))
    train_style_encoder.main(["--config", str(tmp_path / "cfg.yaml"), "--max_epochs", "3", "--lr", "1e-3",
                              "--device", "cpu", f"ckpt_path={tmp_path / 'ckpt'}"])
    recs = [json.loads(line) for line in open(tmp_path / "out" / "metrics.jsonl")]
    assert [r["epoch"] for r in recs] == [0, 1, 2] and all(np.isfinite(r["loss"]) for r in recs)
    with open(tmp_path / "out" / "style_params.pkl", "rb") as f:
        tree = pickle.load(f)
    start = style_params_to_jax(init_style_params(CFG, torch.Generator().manual_seed(0)))
    assert not np.array_equal(tree["head_enc"]["kernel"], start["head_enc"]["kernel"])
    enc, _ = JaxStyleEncoder(spk_emb_dim=CFG.spk_emb_dim).apply(
        {"params": tree}, np.zeros((1, 6, CFG.n_feats), np.float32), np.ones((1, 6)))
    assert np.isfinite(np.asarray(enc)).all()
