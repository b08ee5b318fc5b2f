"""CosyVoice 2's flow stage in the port (``models/cosyflow.py``) against the
plain fp32 reference ``tests/plain_cosyflow.py``, on the CPU at tiny
widths: the loss and every leaf's gradient with streaming on and off,
three ``TrainStep`` steps and their draws, bf16's band, causality on a
streaming step, the relative term and the chunk masks against explicit
(i, j) indexing, T = 2L through the dataset and sampler, the checkpoint's
round trip, the CLI's preset, ``profile_step`` and the frozen FLOP count.

Tolerances: fp32 against fp32, so summation order alone: the loss 1e-5
relative; each leaf's gradient 2e-5 of the larger of its own largest
element and the median leaf's (10× the 2e-6 read: the relative-position
term's backward sums its shifted (T, 2T − 1) product in another order than
the reference's gather); parameters 1e-6 absolute after three steps at the recipe's lr
1e-5 (Adam moves each element by about lr a step).  bf16's loss lies
outside 1e-5 and within 5e-2 relative.  The chunk-causal plain attention
against a dense float64 reference built by loops: 1e-5 (fp32 round-off).
Causality: outputs before the perturbed chunk equal bit for bit (a masked
key adds an exact zero).
"""

from __future__ import annotations

import dataclasses
import filecmp
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_cosyflow as ref
from matcha_tpu_torch.checkpoint import load_checkpoint, load_synthesizer
from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.models import cosyflow
from matcha_tpu_torch.models.config import CosyFlowConfig, model_config_from_dict, tiny_cosy_config
from matcha_tpu_torch.ops import attention as ta
from matcha_tpu_torch.ops import relpos
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.step import Batch, TrainStep, step_seed
from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
CFG = tiny_cosy_config()
OPT = OptimizerConfig(lr=1e-5, weight_decay=0.0, b1=0.9, b2=0.999, eps=1e-8, grad_clip=5.0)
SEED = 2**31 + 9


def ref_cfg(cfg: CosyFlowConfig = CFG) -> dict:
    return {"model": dataclasses.asdict(cfg), "training": {"optimizer": dataclasses.asdict(OPT)}}


def make_batch(rng, b: int, n: int, fill: bool = True, cfg: CosyFlowConfig = CFG) -> Batch:
    """Ragged even rows (the last at the full length), tokens exactly half,
    padded to a 16-token bucket below n/2; the last row a weight-0 fill row."""
    yl = 2 * rng.integers(n // 4, n // 2 + 1, b)
    yl[-1] = n
    xl = yl // 2
    tx = min(n // 2, -(-int(xl.max()) // 16) * 16)
    x = rng.integers(0, cfg.vocab_size, (b, tx)) * (np.arange(tx)[None] < xl[:, None])
    y = rng.standard_normal((b, n, cfg.n_feats)).astype(np.float32) * (np.arange(n)[None] < yl[:, None])[..., None]
    w = np.ones(b, np.float32)
    if fill:
        w[-1] = 0.0
    return Batch(torch.tensor(x), torch.tensor(xl), torch.tensor(y), torch.tensor(yl),
                 torch.zeros(b, 2 * n, cfg.n_feats), torch.tensor(2 * yl),
                 torch.tensor(rng.integers(0, cfg.n_xvectors, b)), torch.tensor(w))


def as_dict(batch: Batch) -> dict:
    return {"x": batch.x, "x_lengths": batch.x_lengths, "y": batch.y, "y_lengths": batch.y_lengths,
            "spks": batch.spks, "weights": batch.weights}


@pytest.fixture(scope="module")
def params0():
    return cosyflow.CosyFlow.init_params(CFG, torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [make_batch(rng, 3, 32), make_batch(rng, 2, 48), make_batch(rng, 4, 24)]


def models(params):
    port = cosyflow.CosyFlow(CFG)
    port.load_state_dict(params)
    plain = ref.CosyFlow(dataclasses.asdict(CFG))
    plain.load_state_dict(params)
    return port, plain


def rel_grad_gaps(got: dict, want: dict) -> dict:
    """Each leaf's max |got − want| over the larger of its own max |want| and the median leaf's."""
    tops = {n: float(w.abs().max()) for n, w in want.items()}
    med = float(np.median(list(tops.values())))
    return {n: float((got[n] - w).abs().max()) / max(tops[n], med) for n, w in want.items()}


@pytest.mark.parametrize("streaming", [False, True], ids=["offline", "streaming"])
def test_loss_and_every_gradient_match_the_reference(params0, batches, streaming):
    port, plain = models(params0)
    batch, step = batches[0], 4
    gen = torch.Generator().manual_seed(step_seed(SEED, step))
    drop = torch.Generator().manual_seed(step_seed(SEED, step, 0, 2))
    got = port.compute_losses(batch.x, batch.x_lengths, batch.y, batch.y_lengths, batch.spks, gen,
                              streaming=streaming, draw_seed=(SEED, step), row_weights=batch.weights,
                              dropout_generator=drop)["loss"]
    want = ref.losses(plain, as_dict(batch), SEED, step, streaming=streaming)["loss"]
    assert abs(float(got.detach()) - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
    g = dict(zip(dict(port.named_parameters()), torch.autograd.grad(got, list(port.parameters()))))
    r = dict(zip(dict(plain.named_parameters()), torch.autograd.grad(want, list(plain.parameters()))))
    assert set(g) == set(r)
    gaps = rel_grad_gaps(g, r)
    assert max(gaps.values()) <= 2e-5, sorted(gaps.items(), key=lambda kv: -kv[1])[:4]


def test_bf16_lies_in_its_band(params0, batches):
    """bf16 products fail the fp32 tolerance and stay near the reference."""
    port = cosyflow.CosyFlow(dataclasses.replace(CFG, compute_dtype="bfloat16"))
    port.load_state_dict(params0)
    _, plain = models(params0)
    batch = batches[0]
    gen = torch.Generator().manual_seed(step_seed(SEED, 0))
    drop = torch.Generator().manual_seed(step_seed(SEED, 0, 0, 2))
    with torch.no_grad():
        got = float(port.compute_losses(batch.x, batch.x_lengths, batch.y, batch.y_lengths, batch.spks, gen,
                                        draw_seed=(SEED, 0), row_weights=batch.weights, dropout_generator=drop)["loss"])
        want = float(ref.losses(plain, as_dict(batch), SEED, 0, streaming=False)["loss"])
    assert 1e-5 < abs(got - want) / abs(want) < 5e-2


def port_steps(params, batches, cfg=CFG):
    ts = TrainStep(cfg, OPT, device="cpu")
    state = ts.init_state({k: v.clone() for k, v in params.items()})
    losses, first_grad = [], None
    for i, b in enumerate(batches):
        state, m = ts.train_step(state, b, SEED)
        losses.append(float(m["loss"]))
        if i == 0:
            first_grad = {n: mu / (1 - OPT.b1) for n, mu in state.opt_state.mu.items()}
    return ts, state, losses, first_grad


def test_three_steps_and_their_draws_match_the_reference(params0, batches):
    ts, state, losses, first_grad = port_steps(params0, batches)
    got = ref.run_steps(ref_cfg(), params0, [as_dict(b) for b in batches], SEED, "cpu")
    for a, b in zip(losses, (x["loss"] for x in got["losses"])):
        assert abs(a - b) <= 1e-5 * abs(b)
    gaps = rel_grad_gaps(first_grad, got["first_grad"])
    assert max(gaps.values()) <= 2e-5
    for n, p in state.params.items():
        assert (p.detach() - got["params"][n]).abs().max().item() <= 1e-6, n
    drawn = {"streaming": sum(x["streaming"] for x in got["losses"]),
             "prompted": sum(x["prompted"] for x in got["losses"]),
             "dropped": sum(x["dropped"] for x in got["losses"])}
    assert ts.model.drawn == drawn


def test_the_draws_have_streams_of_their_own():
    """The streaming flag (seed, step, 0, 1), the rows' draws (0, 3) and the
    dropout masks (0, 2) are apart from the CFM's (seed, step)."""
    ts = TrainStep(CFG, OPT, device="cpu")
    seeds = {step_seed(SEED, 5), ts._dropout_seed(SEED, 5), step_seed(SEED, 5, *cosyflow.STREAM_WORDS),
             step_seed(SEED, 5, *cosyflow.ROW_WORDS)}
    assert len(seeds) == 4 and ts._dropout_seed(SEED, 5) == step_seed(SEED, 5, 0, 2)
    flags = [ts.model.step_kwargs(SEED, s, count=False)["streaming"] for s in range(64)]
    assert 16 < sum(flags) < 48 and ts.model.drawn["streaming"] == 0
    on, u, kept = cosyflow.row_draws(SEED, 5, 400, CFG.cfg_rate)
    assert 150 < int(on.sum()) < 250 and 40 < int((~kept).sum()) < 120 and float(u.max()) < 1.0


def test_parallelism_is_refused():
    with pytest.raises(ValueError, match="one device"):
        TrainStep(CFG, OPT, device="cpu", data_parallel=True)


# ----------------------------------------------------------------- causality


def test_the_estimator_is_causal_on_a_streaming_step(params0):
    """Perturbing y and cond past chunk k leaves the output on chunks ≤ k
    unchanged with the chunk on, and changes it with the chunk off."""
    port, _ = models(params0)
    est, c, n, k = port.decoder.estimator, CFG.estimator_chunk, 32, 1
    gen = torch.Generator().manual_seed(1)
    y, conds = torch.randn(2, n, CFG.n_feats, generator=gen), torch.randn(2, n, 3 * CFG.n_feats, generator=gen)
    t, mask = torch.rand(2, generator=gen), torch.ones(2, n)
    y2, conds2 = y.clone(), conds.clone()
    y2[:, (k + 1) * c:] += 1.0
    conds2[:, (k + 1) * c:, 2 * CFG.n_feats:] += 1.0  # the prompt's channels
    with torch.no_grad():
        for chunk, same in ((c, True), (0, False)):
            a, b = est(y, mask, conds, t, chunk=chunk), est(y2, mask, conds2, t, chunk=chunk)
            assert torch.equal(a[:, :(k + 1) * c], b[:, :(k + 1) * c]) == same, chunk


def test_the_encoder_is_causal_beyond_its_lookahead(params0):
    """Perturbing tokens from 3 past chunk k's end leaves μ on chunks ≤ k
    unchanged with the chunks on; with them off μ there changes."""
    port, _ = models(params0)
    c, n_tok, k = CFG.chunk, 16, 1
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, CFG.vocab_size, (2, n_tok), generator=gen)
    valid = torch.ones(2, n_tok, dtype=torch.bool)
    tokens2 = tokens.clone()
    start = (k + 1) * c + CFG.pre_lookahead
    tokens2[:, start:] = (tokens2[:, start:] + 1) % CFG.vocab_size
    frames = (k + 1) * c * CFG.token_mel_ratio
    with torch.no_grad():
        for chunks, same in ((port.chunks(True), True), (port.chunks(False), False)):
            a, b = port.encode(tokens, valid, chunks), port.encode(tokens2, valid, chunks)
            assert torch.equal(a[:, :frames], b[:, :frames]) == same, chunks
        # one token earlier falls inside chunk k's lookahead
        tokens3 = tokens.clone()
        tokens3[:, start - 1] = (tokens3[:, start - 1] + 1) % CFG.vocab_size
        a, b = port.encode(tokens, valid, port.chunks(True)), port.encode(tokens3, valid, port.chunks(True))
        assert not torch.equal(a[:, :frames], b[:, :frames])


# ----------------------------------------------------------------- attention


def dense_keep(valid: np.ndarray, chunk: int) -> np.ndarray:
    """(B, T, T) by loops: key j valid and j < (i // c + 1)·c."""
    b, t = valid.shape
    keep = np.zeros((b, t, t), bool)
    for r in range(b):
        for i in range(t):
            for j in range(t):
                keep[r, i, j] = valid[r, j] > 0 and (chunk == 0 or j < (i // chunk + 1) * chunk)
    return keep


@pytest.mark.parametrize("chunk", [0, 1, 3, 8])
def test_chunked_plain_attention_matches_a_dense_reference(chunk):
    """The plain forward, lse and backward with a chunk against float64
    attention over a mask built by loops."""
    rng = np.random.default_rng(chunk)
    b, h, t, d = 3, 2, 13, 8
    q, k, v, dout = (torch.tensor(rng.standard_normal((b, h, t, d)), dtype=torch.float32) for _ in range(4))
    valid = torch.tensor([[1.0] * 13, [1.0] * 5 + [0.0] * 8, [1.0] * 9 + [0.0] * 4])
    keep = torch.tensor(dense_keep(valid.numpy(), chunk))[:, None]
    qd, kd, vd = (x.double().requires_grad_() for x in (q, k, v))
    s = (qd @ kd.transpose(-1, -2) / math.sqrt(d)).masked_fill(~keep, float("-inf"))
    want = torch.softmax(s, -1) @ vd
    want_lse = torch.logsumexp(s, -1) / math.log(2.0)
    want_g = torch.autograd.grad(want, (qd, kd, vd), dout.double())
    out = ta.masked_self_attention_plain(q, k, v, valid, chunk=chunk)
    lse = ta.masked_attention_lse_plain(q, k, valid, chunk=chunk)
    assert (out - want).abs().max().item() <= 1e-5
    assert (lse - want_lse).abs().max().item() <= 1e-5
    grads = ta.masked_attention_bwd_plain(q, k, v, dout, lse, ta.masked_attention_delta_plain(dout, out), valid,
                                          chunk=chunk)
    for g, w in zip(grads, want_g):
        assert (g.double() - w).abs().max().item() <= 1e-5
    assert torch.equal(ta.masked_self_attention(q, k, v, valid, chunk=chunk), out)


def test_the_relative_term_reads_position_i_minus_j():
    """``rel_shift`` of (q + w)·pᵀ and the attention's scores against
    explicit (i, j) indexing: row m of p is position T − 1 − m."""
    rng = np.random.default_rng(7)
    b, h, t, d = 2, 3, 9, 4
    bd = torch.tensor(rng.standard_normal((b, h, t, 2 * t - 1)), dtype=torch.float32)
    shifted = relpos.rel_shift(bd)
    for i in range(t):
        for j in range(t):
            assert torch.equal(shifted[..., i, j], bd[..., i, t - 1 - i + j])
    q, k, v = (torch.tensor(rng.standard_normal((b, h, t, d)), dtype=torch.float32) for _ in range(3))
    p = torch.tensor(rng.standard_normal((1, h, 2 * t - 1, d)), dtype=torch.float32)
    u, w = (torch.tensor(rng.standard_normal((h, d)), dtype=torch.float32) for _ in range(2))
    valid = torch.ones(b, t)
    got = relpos.relpos_attention(q, k, v, p, u, w, valid, chunk=4)
    scores = torch.empty(b, h, t, t)
    for i in range(t):
        for j in range(t):
            pos = t - 1 - (i - j)  # the row of position i − j
            scores[..., i, j] = ((q[..., i, :] + u) * k[..., j, :]).sum(-1) + ((q[..., i, :] + w) * p[0, :, pos]).sum(-1)
    scores = (scores / math.sqrt(d)).masked_fill(~torch.tensor(dense_keep(valid.numpy(), 4))[:, None], float("-inf"))
    assert (got - torch.softmax(scores, -1) @ v).abs().max().item() <= 1e-5


def test_the_positions_are_espnets():
    """Row m of the table is position n − 1 − m: sin at even columns, cos at odd."""
    n, width = 5, 8
    table = cosyflow.rel_positions(n, width, "cpu")
    assert table.shape == (2 * n - 1, width)
    for m in range(2 * n - 1):
        r = n - 1 - m
        for kk in range(width // 2):
            f = math.exp(-2 * kk * math.log(10000.0) / width)
            assert table[m, 2 * kk].item() == pytest.approx(math.sin(r * f), abs=1e-6)
            assert table[m, 2 * kk + 1].item() == pytest.approx(math.cos(r * f), abs=1e-6)
    assert torch.equal(table, ref.positions(n, width, "cpu"))


# ----------------------------------------------------------------- data, checkpoints, CLI


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Eleven utterances of even frame counts with tokens exactly half."""
    root = tmp_path_factory.mktemp("cosy_corpus")
    mel_dir = root / "mels"
    (mel_dir / "s").mkdir(parents=True)
    rng = np.random.default_rng(5)
    rows = []
    for i, frames in enumerate(range(10, 54, 4)):
        rel = f"s/u{i}"
        np.save(mel_dir / f"{rel}.npy", rng.standard_normal((CFG.n_feats, frames)).astype(np.float32))
        np.save(mel_dir / f"{rel}.fine.npy", rng.standard_normal((CFG.n_feats, 2 * frames)).astype(np.float32))
        ids = " ".join(str(v) for v in rng.integers(0, CFG.vocab_size, frames // 2))
        rows.append(f"{rel}|{i % CFG.n_xvectors}|en-us|text {i}|{ids}")
    (mel_dir / "metadata.json").write_text('{"n_mels": %d}' % CFG.n_feats)
    (root / "train.csv").write_text("\n".join(rows))
    return root


def cosy_trainer(corpus, out) -> Trainer:
    ds = TextMelDataset(corpus / "train.csv", corpus / "mels")
    return Trainer(CFG, OPT, TrainerConfig(output_dir=str(out), use_mesh=False), ds, max_frames_per_batch=128,
                   len_bucket=32, text_bucket=16, device="cpu")


def test_t_is_twice_l_through_the_dataset_and_sampler(corpus, tmp_path):
    """Every real row's frames are twice its tokens; the token bucket fits
    in half the frame bucket, where the model pads it; a step runs."""
    trainer = cosy_trainer(corpus, tmp_path)
    state = trainer.steps.init_state(generator=torch.Generator().manual_seed(0))
    seen = 0
    for batch in trainer.dm.train_batches(0):
        real = batch.weights > 0
        assert torch.equal(2 * batch.x_lengths[real], batch.y_lengths[real])
        assert batch.x.shape[1] <= batch.y.shape[1] // 2 and batch.y.shape[1] % 2 == 0
        seen += int(real.sum())
        state, m = trainer.train_step(state, batch, 0)
        assert math.isfinite(float(m["loss"]))
    assert seen == 11
    trainer.close()


def test_a_checkpoint_round_trips_and_resumes(corpus, params0, batches, tmp_path):
    trainer = cosy_trainer(corpus, tmp_path)
    state = trainer.steps.init_state({k: v.clone() for k, v in params0.items()})
    for b in batches[:2]:
        state, _ = trainer.train_step(state, b, trainer.cfg.seed)
    trainer.save(state, 0)
    ckpt = tmp_path / "checkpoints" / "epoch_00000"
    _, ckpt_cfg = load_checkpoint(ckpt)
    assert ckpt_cfg == CFG
    assert model_config_from_dict(json.loads((ckpt / "config.json").read_text())) == CFG
    with pytest.raises(ValueError, match="does not serve"):
        load_synthesizer(str(ckpt))
    resumed = trainer.init_state(str(ckpt))
    assert resumed.step == 2
    state, m = trainer.train_step(state, batches[2], trainer.cfg.seed)
    resumed, m2 = trainer.train_step(resumed, batches[2], trainer.cfg.seed)
    assert float(m["loss"]) == float(m2["loss"])
    for n, p in state.params.items():
        assert torch.equal(p, resumed.params[n]), n
    trainer.close()


def test_the_cli_selects_the_cosy_preset(corpus, tmp_path):
    from matcha_tpu_torch.train.__main__ import COSY_PRESET, main

    assert "optimizer.lr=1e-5" in COSY_PRESET
    out = tmp_path / "run"
    tiny = [f"cosy.{f.name}={json.dumps(getattr(CFG, f.name))}" for f in dataclasses.fields(CFG)
            if f.name not in ("arch", "estimator_channels", "compute_dtype") and getattr(CFG, f.name) != getattr(CosyFlowConfig, f.name)]
    main([f"data.train_filelist_path={corpus / 'train.csv'}", f"data.mel_dir={corpus / 'mels'}",
          "arch=cosyvoice2_flow", "data.n_feats=8", *tiny, "cosy.estimator_channels=[32]",
          "cosy.compute_dtype=float32", "data.max_frames_per_batch=128", "trainer.max_epochs=1",
          "trainer.log_every_n_steps=1", f"paths.output_dir={out}", "device=cpu"])
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert any("loss" in r and np.isfinite(r["loss"]) for r in recs)
    _, cfg = load_checkpoint(out / "checkpoints" / "epoch_00000")
    assert cfg == CFG


def test_profile_step_runs_the_flow_stage(capsys):
    from matcha_tpu_torch.utils import flops, profile_step

    args = ["--model", "cosy", "--device", "cpu", "--tiny", "--compute_dtype", "float32", "--batch", "3",
            "--frames", "32", "--iters", "3"]
    assert profile_step.main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["model"] == "cosy" and out["tx"] == 16 and np.isfinite(out["losses"]["last"])
    assert set(out["drawn"]) == {"streaming", "prompted", "dropped"}
    rel = out["attention_launches_per_step"]["relpos_attention"]
    assert sum(rel["by_signature"].values()) == CFG.encoder_layers + CFG.up_layers
    lo, hi = (flops.cosyflow_train_step_flops(CFG, 3, 32, s) for s in (True, False))
    assert lo <= out["flops_per_step"] <= hi


def test_the_preset_is_the_published_model():
    """``CosyFlowConfig()`` is the yaml's flow stage at 112.55 M parameters,
    and the benchmark's configuration is that preset."""
    cfg = CosyFlowConfig()
    with torch.device("meta"):
        model = cosyflow.CosyFlow(cfg)
    assert sum(p.numel() for p in model.parameters()) == 112_549_360
    bench = json.loads((ROOT / "benchmark" / "configs" / "cosyvoice2-flow.json").read_text())
    assert CosyFlowConfig.from_dict(bench["model"]) == cfg


def test_the_flop_count_by_hand():
    """One offline row of n frames: every linear and conv, and attention
    over n² pairs (the encoder's three products, the estimator's two)."""
    cfg, n = CFG, 16
    from matcha_tpu_torch.utils import flops

    d, f, tok = cfg.encoder_dim, cfg.encoder_ffn, n // 2
    layer = lambda t: 2 * t * (4 * d * d + 2 * d * f) * 3 + 2 * (2 * t - 1) * d * d * 2 + 3 * 2 * d * t * t * 3
    enc = 2 * tok * d * d * 3 + 2 * tok * d * d * (4 + 3) * 3 + 2 * layer(tok) + 2 * n * d * d * (5 + 1) * 3
    enc += 2 * layer(n) + 2 * n * d * cfg.n_feats * 3 + 2 * cfg.spk_embed_dim * cfg.n_feats * 2
    c, ch = 4 * cfg.n_feats, cfg.estimator_channels[0]
    inner = cfg.estimator_heads * cfg.estimator_head_dim

    def stage(cin):
        res = 2 * 4 * ch * ch * 3 + 2 * n * (cin * ch * 3 + ch * ch * 3 + cin * ch) * 3
        blk = 2 * n * (3 * ch * inner + inner * ch + 8 * ch * ch) * 3 + 2 * 2 * inner * n * n * 3
        return res + cfg.estimator_blocks * blk

    est = 2 * c * 4 * ch * 2 + 2 * 16 * ch * ch * 3 + stage(c) + cfg.estimator_mid * stage(ch) + stage(2 * ch)
    est += 2 * n * ch * ch * 3 * 3 * 3 + 2 * n * ch * cfg.n_feats * 3
    assert flops.cosyflow_train_step_flops(cfg, 1, n, False) == pytest.approx(enc + est)
    assert flops.cosyflow_train_step_flops(cfg, 2, n, False) == pytest.approx(2 * (enc + est))


def test_the_benchmark_counts_the_programs_flops():
    """``benchmark/flops_cosy.py`` is a frozen copy of ``utils/flops.py``'s count."""
    from matcha_tpu_torch.utils import flops

    spec = importlib.util.spec_from_file_location("bench_flops_cosy", ROOT / "benchmark" / "flops_cosy.py")
    frozen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(frozen)
    for cfg in (CFG, CosyFlowConfig()):
        for n in (24, 400, 1504):
            for s in (False, True):
                assert frozen.train_step_flops(cfg, 2, n, s) == flops.cosyflow_train_step_flops(cfg, 2, n, s)
                assert frozen.kept_pairs(n, 50 if s else 0) == flops.kept_pairs(n, 50 if s else 0)


def test_the_reference_has_one_text():
    assert filecmp.cmp(ROOT / "tests" / "plain_cosyflow.py", ROOT / "benchmark" / "reference" / "cosyflow.py",
                       shallow=False)
