"""F5-TTS's DiT in the port (``models/dit.py``) against the plain fp32
reference ``tests/plain_f5tts.py``, on the CPU at tiny widths: the forward,
one and three ``TrainStep`` steps (loss, every leaf's gradient, the
parameters after the CPU AdamW loop), the draws, bf16's band, the
reference's two copies, a checkpoint's resume, the refusals, the training
CLI's preset; and MatchaTTS's step unchanged by the dispatch.

Tolerances: fp32 forward 1e-5 of the largest output; fp32 step losses
1e-5 relative, gradients 1e-5 of each leaf's largest element (or of the
median leaf's where a leaf is smaller), parameters 1e-6 absolute after
three steps at F5's lr 7.5e-5 (Adam moves each element by about lr a
step).  bf16's loss lies between 1e-5 and 2e-2 relative.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import functional_call

import plain_f5tts as ref
from matcha_tpu_torch.checkpoint import load_checkpoint, load_synthesizer
from matcha_tpu_torch.data.dataset import TextMelDataset
from matcha_tpu_torch.models import dit
from matcha_tpu_torch.models.config import DiTConfig, tiny_config, tiny_dit_config
from matcha_tpu_torch.models.matcha import MatchaTTS
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.step import Batch, TrainStep, step_seed
from matcha_tpu_torch.train.trainer import Trainer, TrainerConfig
from matcha_tpu_torch.utils.profile_step import synthetic_batch

ROOT = Path(__file__).resolve().parents[1]
CFG = tiny_dit_config()
OPT = OptimizerConfig(lr=7.5e-5, weight_decay=0.01, b1=0.9, b2=0.999, eps=1e-8, grad_clip=1.0)
SEED = 2**31 + 5


def ref_cfg(cfg: DiTConfig = CFG) -> dict:
    return {"model": dataclasses.asdict(cfg), "training": {"optimizer": dataclasses.asdict(OPT)}}


def make_batch(rng, b: int, n: int, tx: int, fill: bool = True) -> Batch:
    """Ragged rows (the last at the full length), ids in proportion, the
    last row a weight-0 fill row when ``fill``."""
    yl = rng.integers(n // 2, n + 1, b)
    yl[-1] = n
    xl = np.clip(yl * tx // n, 1, tx)
    x = rng.integers(1, 600, (b, tx)) * (np.arange(tx)[None] < xl[:, None])
    y = rng.standard_normal((b, n, CFG.n_feats)).astype(np.float32) * (np.arange(n)[None] < yl[:, None])[..., None]
    w = np.ones(b, np.float32)
    if fill:
        w[-1] = 0.0
    return Batch(torch.tensor(x), torch.tensor(xl), torch.tensor(y), torch.tensor(yl),
                 torch.zeros(b, 2 * n, CFG.n_feats), torch.tensor(2 * yl), torch.zeros(b, dtype=torch.long),
                 torch.tensor(w))


def as_dict(batch: Batch) -> dict:
    return {"x": batch.x, "x_lengths": batch.x_lengths, "y": batch.y, "y_lengths": batch.y_lengths,
            "weights": batch.weights}


@pytest.fixture(scope="module")
def params0():
    return dit.init_params(CFG, torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [make_batch(rng, 3, 40, 8), make_batch(rng, 2, 56, 10), make_batch(rng, 4, 24, 6)]


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


@pytest.fixture(scope="module")
def both(params0, batches):
    ts, state, losses, first_grad = port_steps(params0, batches)
    got = ref.run_steps(ref_cfg(), params0, [as_dict(b) for b in batches], SEED, "cpu")
    return ts, state, losses, first_grad, got


@pytest.mark.parametrize("drop", [(False, False), (True, False), (True, True)], ids=["none", "audio", "both"])
def test_fp32_forward_matches_the_reference(params0, drop):
    rng = np.random.default_rng(1)
    b = make_batch(rng, 3, 48, 9)
    port = dit.F5TTS(CFG)
    port.load_state_dict(params0)
    plain = ref.F5TTS(dataclasses.asdict(CFG))
    plain.load_state_dict(params0)
    n = b.y.shape[1]
    gen = torch.Generator().manual_seed(4)
    xt, cond = torch.randn(b.y.shape, generator=gen), b.y.clone()
    t = torch.rand((3,), generator=gen)
    keep = (torch.arange(n)[None] < b.y_lengths[:, None])
    with torch.no_grad():
        text = port.transformer.text_embed(b.x, b.x_lengths, n, drop[1])
        text_ref = plain.transformer.text_embed(b.x, b.x_lengths, n, drop[1])
        got = port.transformer(xt, cond, text, t, keep[..., None], drop[0], None)
        want = plain.transformer(xt, cond, text_ref, t, keep, drop[0], None)
    assert (text - text_ref).abs().max() <= 1e-5 * text_ref.abs().max()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_one_step_matches_the_reference(both):
    _, _, losses, first_grad, got = both
    assert losses[0] == pytest.approx(got["losses"][0]["loss"], rel=1e-5)
    med = float(np.median([float(g.abs().max()) for g in got["first_grad"].values()]))
    for name, g in got["first_grad"].items():
        err = float((first_grad[name] - g).abs().max())
        assert err <= 1e-5 * max(float(g.abs().max()), med), name


def test_three_steps_match_the_reference(both):
    ts, state, losses, _, got = both
    assert losses == pytest.approx([x["loss"] for x in got["losses"]], rel=1e-5)
    for name, p in got["params"].items():
        assert float((state.params[name].detach() - p).abs().max()) <= 1e-6, name
    assert ts.model.dropped == {"audio": sum(x["drop_audio"] for x in got["losses"]),
                          "text": sum(x["drop_text"] for x in got["losses"])}


def test_the_draws_are_the_references():
    lens = torch.tensor([30, 17, 40, 1])
    a, b = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    span, x0, t = dit.cfm_draws(lens, (4, 40, 8), a)
    span_r, x0_r, t_r = ref.draws(lens, (4, 40, 8), b)
    assert torch.equal(span, span_r) and torch.equal(x0, x0_r) and torch.equal(t, t_r)
    frac = span.sum(1) / lens
    assert bool(((frac >= 0.7 - 1 / lens) & (frac <= 1.0)).all())
    assert not bool((span & (torch.arange(40)[None] >= lens[:, None])).any())
    drops = [dit.guidance_drops(SEED, s) for s in range(2000)]
    assert drops == [ref.drops(SEED, s) for s in range(2000)]
    audio, text = np.mean([d[0] for d in drops]), np.mean([d[1] for d in drops])
    assert abs(text - 0.2) < 0.03 and abs(audio - (0.2 + 0.8 * 0.3)) < 0.03
    assert all(a for a, t in drops if t)


def test_bf16_lies_in_its_own_band(params0, batches):
    _, _, losses, _ = port_steps(params0, batches[:1], dataclasses.replace(CFG, compute_dtype="bfloat16"))
    got = ref.run_steps(ref_cfg(), params0, [as_dict(batches[0])], SEED, "cpu")
    rel = abs(losses[0] - got["losses"][0]["loss"]) / got["losses"][0]["loss"]
    assert 1e-5 < rel < 2e-2


def test_the_two_reference_copies_agree(params0, batches):
    spec = importlib.util.spec_from_file_location("bench_f5tts", ROOT / "benchmark" / "reference" / "f5tts.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    inputs = [as_dict(b) for b in batches[:2]]
    a = ref.run_steps(ref_cfg(), params0, inputs, SEED, "cpu")
    b = bench.run_steps(ref_cfg(), params0, inputs, SEED, "cpu")
    assert a["losses"] == b["losses"]
    for key in ("first_grad", "params"):
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four utterances of 30 frames: two batches of two at 64 frames."""
    root = tmp_path_factory.mktemp("f5corpus")
    mel_dir = root / "mels"
    (mel_dir / "s").mkdir(parents=True)
    rng = np.random.default_rng(5)
    rows = []
    for i in range(4):
        rel = f"s/u{i}"
        np.save(mel_dir / f"{rel}.npy", rng.standard_normal((CFG.n_feats, 30)).astype(np.float32))
        np.save(mel_dir / f"{rel}.fine.npy", rng.standard_normal((CFG.n_feats, 60)).astype(np.float32))
        ids = " ".join(str(v) for v in rng.integers(1, 600, 6))
        rows.append(f"{rel}|0|en-us|text {i}|{ids}")
    (mel_dir / "metadata.json").write_text('{"n_mels": %d}' % CFG.n_feats)
    (root / "train.csv").write_text("\n".join(rows))
    return root


def test_resume_continues_as_an_uninterrupted_run(corpus, params0, batches, tmp_path):
    ds = TextMelDataset(corpus / "train.csv", corpus / "mels")
    trainer = Trainer(CFG, OPT, TrainerConfig(output_dir=str(tmp_path), use_mesh=False), ds,
                      max_frames_per_batch=64, device="cpu")
    state = trainer.steps.init_state({k: v.clone() for k, v in params0.items()})
    for b in batches[:2]:
        state, _ = trainer.train_step(state, b, trainer.cfg.seed)
    trainer.save(state, 0)
    _, ckpt_cfg = load_checkpoint(tmp_path / "checkpoints" / "epoch_00000")
    assert ckpt_cfg == CFG
    with pytest.raises(ValueError, match="does not serve"):
        load_synthesizer(str(tmp_path / "checkpoints" / "epoch_00000"))
    resumed = trainer.init_state(str(tmp_path / "checkpoints" / "epoch_00000"))
    assert resumed.step == 2
    state, m = trainer.train_step(state, batches[2], trainer.cfg.seed)
    resumed, m2 = trainer.train_step(resumed, batches[2], trainer.cfg.seed)
    assert float(m["loss"]) == float(m2["loss"])
    for n, p in state.params.items():
        assert torch.equal(p, resumed.params[n]), n
        assert torch.equal(state.opt_state.nu[n], resumed.opt_state.nu[n]), n
    trainer.close()


@pytest.mark.parametrize("model", ["dit", "matcha"])
def test_the_class_sets_the_dropout_stream_and_the_decay(model):
    """The DiT's dropout masks come from (seed, step, 0, 2), a stream apart
    from its span, x₀ and t on (seed, step); MatchaTTS keeps (seed, step,
    rank).  The DiT decays every leaf, MatchaTTS its kernels alone."""
    cfg = CFG if model == "dit" else tiny_config()
    ts = TrainStep(cfg, OPT, device="cpu")
    words = (0, 2) if model == "dit" else (0,)
    assert ts._dropout_seed(SEED, 5) == step_seed(SEED, 5, *words)
    # MatchaTTS's rank 0 shares the step's seed (SeedSequence pads with zeros); the DiT's does not
    assert (ts._dropout_seed(SEED, 5) == step_seed(SEED, 5)) == (model == "matcha")
    mask = ts.opt.decay
    assert set(mask) == set(ts.model.state_dict())
    if model == "dit":
        assert all(mask.values())
    else:
        assert not mask["encoder.emb.weight"] and not mask["encoder.proj_m.0.bias"] and mask["encoder.proj_m.0.weight"]


@pytest.mark.parametrize("kind", ["data_parallel", "tensor_parallel"])
def test_parallelism_is_refused(kind):
    kw = {"data_parallel": True} if kind == "data_parallel" else {"mesh2d": object()}
    with pytest.raises(ValueError, match="one device"):
        TrainStep(CFG, OPT, device="cpu", **kw)


def test_matcha_step_is_the_plain_call_bit_for_bit():
    """MatchaTTS's step through the dispatch: the losses and gradients of a
    direct ``functional_call`` on the same generators, bit for bit, and the
    same metric names."""
    cfg = tiny_config()
    ts = TrainStep(cfg, OptimizerConfig(), device="cpu")
    state = ts.init_state(generator=torch.Generator().manual_seed(0))
    params = {n: p.detach().clone().requires_grad_(True) for n, p in state.params.items()}
    batch = synthetic_batch(cfg, 3, 16, 24)
    caught = {}
    update = ts.opt.update
    ts.opt.update = lambda p, g, s: (caught.update(g), update(p, g, s))[1]
    _, metrics = ts.train_step(state, batch, SEED)
    model = MatchaTTS(cfg)
    gen = torch.Generator().manual_seed(step_seed(SEED, 0))
    losses = functional_call(model, params, (batch.x, batch.x_lengths, batch.y, batch.y_lengths, batch.y_fine,
                                             batch.y_fine_lengths, batch.spks, gen),
                             {"row_weights": batch.weights,
                              "dropout_generator": torch.Generator().manual_seed(step_seed(SEED, 0, 0))})
    grads = torch.autograd.grad(losses["loss"], list(params.values()), allow_unused=True)
    assert set(metrics) == {"loss", "sub_loss/diff", "sub_loss/dur", "sub_loss/prior", "grad_norm"}
    for key, name in (("loss", "loss"), ("diff_loss", "sub_loss/diff"), ("dur_loss", "sub_loss/dur"),
                      ("prior_loss", "sub_loss/prior")):
        assert torch.equal(metrics[name], losses[key].detach()), name
    for (n, p), g in zip(params.items(), grads):
        assert torch.equal(caught[n], torch.zeros_like(p) if g is None else g), n


def test_the_cli_selects_the_dit_preset(corpus, tmp_path):
    from matcha_tpu_torch.train.__main__ import main

    out = tmp_path / "run"
    main([f"data.train_filelist_path={corpus / 'train.csv'}", f"data.mel_dir={corpus / 'mels'}",
          f"data.valid_filelist_path={corpus / 'train.csv'}", "arch=f5tts_dit", "data.n_feats=8",
          "dit.dim=64", "dit.depth=2", "dit.heads=4", "dit.dim_head=16", "dit.text_dim=32", "dit.conv_layers=2",
          "dit.compute_dtype=float32", "data.max_frames_per_batch=64", "trainer.max_epochs=1",
          "trainer.check_val_every_n_epoch=1", "trainer.log_every_n_steps=1", f"paths.output_dir={out}",
          "device=cpu"])
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if "loss" in r] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert any("loss/val" in r for r in recs)
    _, cfg = load_checkpoint(out / "checkpoints" / "epoch_00000")
    assert isinstance(cfg, DiTConfig) and cfg.depth == 2 and cfg.n_feats == 8
    cfg_json = json.loads((out / "checkpoints" / "epoch_00000" / "config.json").read_text())
    assert cfg_json["arch"] == "f5tts_dit"


def test_profile_step_runs_the_dit(capsys):
    from matcha_tpu_torch.utils import flops, profile_step

    args = ["--model", "f5", "--device", "cpu", "--tiny", "--compute_dtype", "float32", "--batch", "3", "--tx", "8",
            "--frames", "32", "--iters", "2"]
    assert profile_step.main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["model"] == "f5" and out["flops_per_step"] == flops.dit_train_step_flops(CFG, 3, 32)
    assert set(out["dropped"]) == {"audio", "text"} and np.isfinite(out["losses"]["last"])


def test_the_benchmark_counts_the_programs_flops():
    """``benchmark/flops_f5.py`` is a frozen copy of ``utils/flops.py``'s DiT count."""
    from matcha_tpu_torch.utils import flops

    spec = importlib.util.spec_from_file_location("bench_flops_f5", ROOT / "benchmark" / "flops_f5.py")
    frozen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(frozen)
    for cfg in (CFG, DiTConfig()):
        for n in (24, 750, 2848):
            assert frozen.train_step_flops(cfg, 2, n) == flops.dit_train_step_flops(cfg, 2, n)


def test_the_preset_is_the_published_model():
    """``DiTConfig()`` is F5-TTS v1 Base at 336.10 M parameters over the
    port's vocabulary, and the benchmark's configuration is that preset."""
    from matcha_tpu_torch.text.symbols import N_VOCAB

    cfg = DiTConfig()
    assert cfg.n_vocab == N_VOCAB
    with torch.device("meta"):
        assert sum(p.numel() for p in dit.F5TTS(cfg).parameters()) == 336_100_964
    bench = json.loads((ROOT / "benchmark" / "configs" / "f5tts-v1-base.json").read_text())
    assert DiTConfig.from_dict(bench["model"]) == cfg
