"""The plain reference against the program, both in fp32 on the CPU at
tiny widths: one request's audio, and one training step's losses and
update."""

import numpy as np
import torch

from benchmark import harness, run as bench_run, workload_gen
from benchmark.reference import synthesis as ref_syn
from benchmark.reference import train as ref_train
from benchmark.reference.noise import seeded_synthesis_noise
from benchmark.tests import tiny


def _cfg(name):
    cfg = bench_run._merge(harness.config(name), tiny.overrides("v20-serve-single" if "v20" in name
                                                                else "base-train")["config"])
    cfg["model"] = dict(cfg["model"], compute_dtype="float32")
    if "vocos" in cfg:
        cfg["vocos"] = dict(cfg["vocos"], compute_dtype="float32")
    return cfg


def test_reference_synthesis_matches_the_program():
    from matcha_tpu_torch.inference import MatchaSynthesizer
    from matcha_tpu_torch.models.config import MatchaConfig
    from matcha_tpu_torch.vocoder.vocos import VocosConfig

    torch.set_num_threads(1)
    cfg = _cfg("matcha24k-v20")
    params, vparams = harness.make_weights(cfg, 2**31 + 5, "cpu", vocoder=True)
    synth = MatchaSynthesizer(MatchaConfig.from_dict(cfg["model"]), params, vparams,
                              VocosConfig(**cfg["vocos"]), device="cpu")
    model, vocos = ref_syn.build(cfg, params, vparams, "cpu")
    noise = seeded_synthesis_noise(512, cfg["model"]["n_feats"])
    for n, voice in ((7, "3"), (23, "2(50)+15(50)"), (40, "15")):
        ids = list(np.random.default_rng(n).integers(1, 600, n))
        mix = workload_gen.voice_mix(voice)
        got = synth.synthesise_ids(ids, voice_mix=mix, fused=True).wav
        refs = ref_syn.waveforms(model, vocos, cfg, ids, mix, noise)
        assert min(ref_syn.audio_rel_err(got, r) for r in refs) < 1e-3
        assert min(ref_syn.audio_gap_db(got, r) for r in refs) < 0.01
        assert min(np.abs(got - r).max() for r in refs if len(r) == len(got)) < 1e-3


def test_reference_training_step_matches_the_program():
    from matcha_tpu_torch.models.config import MatchaConfig
    from matcha_tpu_torch.train.optim import OptimizerConfig
    from matcha_tpu_torch.train.step import Batch, TrainStep

    torch.set_num_threads(1)
    cfg = _cfg("matcha24k-base")
    params, _ = harness.make_weights(cfg, 99, "cpu", vocoder=False)
    g = np.random.default_rng(0)
    b, tx, ty, c = 3, 12, 32, cfg["model"]["n_feats"]
    x_len, y_len = np.array([12, 9, 5]), np.array([32, 25, 12])
    batch = {"x": torch.from_numpy(g.integers(1, 600, (b, tx)) * (np.arange(tx) < x_len[:, None])),
             "x_lengths": torch.from_numpy(x_len), "y_lengths": torch.from_numpy(y_len),
             "y_fine_lengths": torch.from_numpy(2 * y_len), "spks": torch.tensor([0, 5, 15]),
             "weights": torch.tensor([1.0, 1.0, 0.0])}
    fine = torch.from_numpy(g.standard_normal((b, 2 * ty, c)).astype(np.float32))
    fine = fine * (torch.arange(2 * ty)[None, :, None] < 2 * batch["y_lengths"][:, None, None])
    batch["y_fine"], batch["y"] = fine, 0.5 * (fine[:, ::2] + fine[:, 1::2])
    ts = TrainStep(MatchaConfig.from_dict(cfg["model"]), OptimizerConfig(**cfg["training"]["optimizer"]), "cpu")
    state = ts.init_state(params)
    order = ("x", "x_lengths", "y", "y_lengths", "y_fine", "y_fine_lengths", "spks", "weights")
    state, metrics = ts.train_step(state, Batch(*(batch[k] for k in order)), 1234)
    got = ref_train.run_steps(cfg, params, [batch], 1234, "cpu")
    assert abs(float(metrics["loss"]) - got["losses"][0]["loss"]) < 1e-5 * abs(got["losses"][0]["loss"])
    # the gradient as the optimizer took it (Adam's first moment over 1 - b1);
    # the update itself divides by |g| and so magnifies round-off where g ~ 0
    b1 = cfg["training"]["optimizer"]["b1"]
    for name, mu in state.opt_state.mu.items():
        g_p, g_r = mu / (1 - b1), got["first_grad"][name]
        assert torch.allclose(g_p, g_r, rtol=1e-3, atol=1e-4 * float(g_r.norm()) + 1e-12), name
