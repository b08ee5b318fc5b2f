"""The port's benchmark (``matcha_tpu_torch/bench.py``) against the JAX
system's ``bench.py``, and the analytic FLOP count (``utils/flops.py``).

tiny_config + a narrow Vocos, fp32 on the CPU; the JAX weights are bridged
into the port and both packages' duration heads are pinned at 4 fine
frames a token, as the benchmark pins them.  Tolerances: stage A's prior
rtol 1e-5 (fp32, another summation order), durations equal; the fused
waveform 1e-3 of its peak, as ``tests/test_torch_inference.py`` holds the
fused path.  The FLOP count equals ``FlopCounterMode`` on the port's plain
path within 1 %.
"""

import ast
import dataclasses
import json
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench as jax_bench
from matcha_tpu.inference import MatchaSynthesizer as JaxSynthesizer
from matcha_tpu.models.config import tiny_config as jax_tiny_config
from matcha_tpu.models.matcha import init_params
from matcha_tpu.vocoder.vocos import VocosConfig as JaxVocosConfig
from matcha_tpu.vocoder.vocos import init_vocos_params
from matcha_tpu_torch import bench
from matcha_tpu_torch.inference import MatchaSynthesizer
from matcha_tpu_torch.models.config import MatchaConfig, tiny_config
from matcha_tpu_torch.train.optim import OptimizerConfig
from matcha_tpu_torch.train.step import Batch, TrainStep
from matcha_tpu_torch.utils import flops
from matcha_tpu_torch.vocoder.vocos import VocosConfig
from matcha_tpu_torch.weights import params_from_jax, vocos_params_from_jax

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = dict(input_channels=8, dim=32, intermediate_dim=64, num_layers=1)
BUCKETS = dict(text_buckets=(16, 32, 64), mel_fine_buckets=(64, 128, 256))
TX, FINE = 16, 64


@pytest.fixture(scope="module")
def pair():
    """(JAX synthesizer, port synthesizer) on the same weights, duration
    heads pinned as the benchmark pins them."""
    cfg = jax_tiny_config()
    params = jax.tree.map(np.asarray, init_params(cfg, jax.random.PRNGKey(0)))
    head = params["encoder"]["proj_w"][f"Conv_{cfg.duration_predictor.n_layers}"]
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = np.full_like(head["bias"], math.log(2.0 + bench.FRAMES_PER_TOKEN))
    vparams = jax.tree.map(np.asarray, init_vocos_params(jax.random.PRNGKey(1), JaxVocosConfig(**WIDTHS)))
    ref = JaxSynthesizer(cfg, params, vparams, JaxVocosConfig(**WIDTHS), **BUCKETS)
    port = MatchaSynthesizer(tiny_config(), params_from_jax(params, tiny_config()),
                             vocos_params_from_jax(vparams, VocosConfig(**WIDTHS)), VocosConfig(**WIDTHS),
                             device="cpu", **BUCKETS)
    return ref, port


@pytest.fixture(scope="module")
def points(pair):
    """bench.py's ``measure`` and the port's at the same (batch, tx, bucket, seed)."""
    ref, port = pair
    jax_point = jax_bench.measure(ref, jax_tiny_config(), batch=2, iters=1, seed=5, tx=TX, y_fine_len=FINE)
    port_point = bench.measure(port, tiny_config(), batch=2, iters=1, seed=5, tx=TX, y_fine_len=FINE)
    return jax_point, port_point


def test_measure_draws_bench_pys_ids(points):
    jax_point, port_point = points
    jax_ids, port_ids = jax_point["_rerun"][2], port_point["_rerun"]["x_all"]
    assert len(jax_ids) == len(port_ids) == 2
    for a, b in zip(jax_ids, port_ids):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_stage_a_equals_jax_encode(points):
    """Stage A's outputs (from the last id draw) against ``_encode_jit``'s on
    the same bridged, pinned weights."""
    jax_point, port_point = points
    ji, pi = jax_point["_inputs"], port_point["_inputs"]
    np.testing.assert_allclose(pi["mu_x"].numpy(), np.asarray(ji["mu_x"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pi["durations"].numpy(), np.asarray(ji["durations"]))
    # pinned: every token 4 fine frames, so the bucket is full of speech
    assert np.all(pi["durations"].numpy() == bench.FRAMES_PER_TOKEN)
    np.testing.assert_array_equal(pi["totals"].numpy(), np.minimum(np.asarray(ji["totals"]), FINE))


def test_measure_accounting_equals_bench_py(points):
    jax_point, port_point = points
    assert port_point["audio_seconds"] == jax_point["audio_seconds"]
    assert port_point["batch"] == jax_point["batch"] == 2
    seconds = bench.audio_seconds(2, FINE)
    assert abs(port_point["rtf"] * seconds * 1e3 - port_point["total_ms"]) <= 1.1e-3
    spread = port_point["spread_ms"]
    assert set(spread) == {"encoder_ms", "decode_vocoder_ms"} and spread["encoder_ms"]["n"] == 1


def test_fused_output_equals_jax_fused(pair):
    """The path ``measure_fused`` times against ``_fused_jit`` at the
    bench's operating point (midpoint/4) and bucket."""
    ref, port = pair
    jax_point = jax_bench.measure_fused(ref, jax_tiny_config(), batch=2, iters=1, seed=3, tx=TX)
    port_point = bench.measure_fused(port, tiny_config(), batch=2, iters=1, seed=3, tx=TX)
    assert port_point["y_fine_len"] == jax_point["y_fine_len"] == FINE
    x = np.random.default_rng(3).integers(0, 600, (2, TX))
    lengths, spk, _, scale = bench._stage_a_host(tiny_config(), 2, TX)
    _, jwav, jtotal = ref._fused_jit(ref.params, ref.vocos_params, jax.numpy.asarray(x, jax.numpy.int32),
                                     jax.numpy.asarray(lengths.numpy(), jax.numpy.int32), spk.numpy(), spk.numpy(),
                                     scale.numpy(), y_fine_len=FINE, n_timesteps=bench.N_TIMESTEPS,
                                     solver=bench.SOLVER)
    totals, wav = bench.fused_call(port, (torch.from_numpy(x), lengths, spk, spk, scale), FINE)
    np.testing.assert_array_equal(totals, np.asarray(jtotal))
    jwav = np.asarray(jwav)
    assert wav.shape == jwav.shape
    np.testing.assert_allclose(wav, jwav, atol=1e-3 * np.abs(jwav).max())


@pytest.mark.parametrize("fused16", [
    {"rtf": 0.001, "total_ms": 90.0, "flops": 9e11},
    {"rtf": 0.001, "total_ms": 90.0, "flops": 0.0},
    None,
    {"error": "RuntimeError: boom"},
])
def test_pick_headline_chooses_as_bench_py(fused16):
    """Same choice of headline as bench.py on the same inputs; the MFU is
    the same FLOP count over the same time, against the H100's peak."""
    copy = lambda d: dict(d) if isinstance(d, dict) else d  # noqa: E731 (pick_headline pops)
    jrtf, jpath, jmfu, _ = jax_bench.pick_headline(0.00126, 9e11, 110.0, copy(fused16))
    rtf, path, mfu, src = bench.pick_headline(0.00126, 9e11, 110.0, copy(fused16))
    assert (rtf, path) == (jrtf, jpath) and src == "analytic"
    assert mfu == pytest.approx(jmfu * jax_bench.V5E_PEAK_FLOPS / bench.H100_PEAK_BF16_FLOPS, rel=1e-12)
    ms = 90.0 if path == "fused_single_dispatch_b16" else 110.0
    assert mfu == pytest.approx(9e11 / (ms / 1e3) / 989e12, rel=1e-12)


def test_device_probe_on_the_cpu(pair):
    """The probe's bodies run (eagerly on the CPU) and give finite stage
    estimates."""
    _, port = pair
    point = bench.measure(port, tiny_config(), batch=2, iters=1, tx=TX, y_fine_len=FINE)
    dev = bench.device_probe(port, point, k=2, reps=1)
    assert all(np.isfinite(dev[k]) for k in ("device_encode_ms", "device_decode_ms"))


# -- the JSON line -------------------------------------------------------------

def _bench_py_keys() -> set[str]:
    """The keys of bench.py's printed ``result``, read off its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "result" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py has no result dict")


def test_main_on_the_cpu_prints_every_key(capsys, monkeypatch):
    """``--device cpu --tiny``: the parity line (the tier run for real, at
    full width), then one line with bench.py's keys and the port's; the
    device-only fields are null and named."""
    monkeypatch.setenv("BENCH_SCALING", "1")
    rc = bench.main(["--device", "cpu", "--tiny", "--iters", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(lines) == 2
    parity, result = json.loads(lines[0]), json.loads(lines[1])
    assert parity["bar_misses"] == [] and "fp32_vs_fp32_oracle" in parity["parity"]
    new = {"device", "spread_ms", "device_idle_share", "device_events_per_call", "device_probe", "durations",
           "not_measured", "batch_scaling", "parity"}
    assert _bench_py_keys() | new <= set(result)
    for key in bench.DEVICE_FIELDS:
        assert result[key] is None and key in result["not_measured"]
    assert result["metric"] == "batched_synthesis_rtf_cpu_harness" and result["device"]["platform"] == "cpu"
    assert result["mfu_flops_source"] == "analytic" and result["durations"] == "pinned 4 fine frames/token"
    assert result["headline_path"] == "fused_single_dispatch_b16"
    assert result["stage_breakdown"]["tflops_per_call"] == pytest.approx(
        flops.synthesis_flops(*bench.configs("bfloat16", True), 16, TX, FINE) / 1e12, abs=1e-6)
    assert set(result["batch_scaling"]) == {"1", "8", "16", "32"}
    assert result["spread_ms"]["latency_b1_fused"]["n"] == bench.B1_ITERS == 20
    assert result["spread_ms"]["fused_b16"]["n"] == 2 and result["compute_dtype"] == "bfloat16"
    assert result["fused_b16"]["y_fine_len"] == FINE and np.isfinite(result["value"])


def test_main_refuses_when_a_parity_bar_is_missed(capsys, monkeypatch):
    monkeypatch.setattr(bench, "parity", lambda device: ({"stub": 1}, ["fp32 mel MCD 0.2 dB"]))
    assert bench.main(["--device", "cpu", "--tiny"]) == 1
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["bar_misses"] == ["fp32 mel MCD 0.2 dB"]
    assert "no number reported" in out.err


def test_main_without_a_card_raises(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
    assert capsys.readouterr().out == ""


# -- the FLOP count ------------------------------------------------------------

def _tiny_port(compute_dtype="float32"):
    cfg, vcfg = bench.configs(compute_dtype, tiny=True)
    return cfg, vcfg, bench.build_synthesizer(cfg, vcfg, "cpu", tiny=True)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("solver", ["midpoint", "euler"])
def test_synthesis_flops_equal_flop_counter(batch, solver):
    cfg, vcfg, synth = _tiny_port()
    x = torch.randint(0, 600, (batch, TX))
    lengths, spk, _, scale = bench._stage_a_host(cfg, batch, TX)
    with FlopCounterMode(display=False) as counter:
        synth.replicas[0].synth_fused(x, lengths, spk, spk, scale, y_fine_len=FINE, n_timesteps=4, solver=solver)
    want = flops.synthesis_flops(cfg, vcfg, batch, TX, FINE, 4, solver)
    assert want == pytest.approx(counter.get_total_flops(), rel=0.01)


def test_train_step_flops_equal_flop_counter():
    cfg = tiny_config()
    ts = TrainStep(cfg, OptimizerConfig(), device="cpu")
    state = ts.init_state(generator=torch.Generator().manual_seed(1))
    b, tx, frames = 3, 12, 32
    batch = Batch(torch.randint(1, 600, (b, tx)), torch.tensor([12, 10, 7]), torch.randn(b, frames, cfg.n_feats),
                  torch.tensor([32, 30, 20]), torch.randn(b, 2 * frames, cfg.n_feats), torch.tensor([64, 60, 40]),
                  torch.tensor([0, 1, 2]))
    with FlopCounterMode(display=False) as counter:
        ts.train_step(state, batch, 0)
    assert flops.train_step_flops(cfg, b, tx, frames) == pytest.approx(counter.get_total_flops(), rel=0.01)


def test_full_width_request_count_is_pinned():
    """B=1 at (256 → 1024), midpoint/4, full width: 155.90 GFLOP, what
    FlopCounterMode counted on the port's plain path; from the formula
    alone, the model is not run."""
    got = flops.synthesis_flops(MatchaConfig(), VocosConfig(), 1, 256, 1024, 4, "midpoint")
    assert got == 155_897_970_688
    assert got == pytest.approx(155.9e9, rel=0.02)
    # the same work at B=16 is 16 times one request; a step counts its backward
    assert flops.synthesis_flops(MatchaConfig(), VocosConfig(), 16, 256, 1024) == 16 * got
    assert flops.train_step_flops(MatchaConfig(), 62, 224, 512) > 2 * flops.forward_flops(
        flops.decoder_products(MatchaConfig(), 62, 512))


def test_flops_do_not_depend_on_the_attention_route():
    cfg = dataclasses.replace(MatchaConfig(), attention_backend="einsum")
    assert flops.synthesis_flops(cfg, VocosConfig(), 1, 256, 1024) == flops.synthesis_flops(
        MatchaConfig(), VocosConfig(), 1, 256, 1024)


def test_flops_refuse_what_they_do_not_count():
    conformer = dataclasses.replace(MatchaConfig().decoder, block_type="conformer")
    with pytest.raises(ValueError, match="transformer"):
        flops.decoder_products(dataclasses.replace(MatchaConfig(), decoder=conformer), 1, 512)
    with pytest.raises(ValueError, match="solver"):
        flops.unet_evaluations(4, "dopri5")
