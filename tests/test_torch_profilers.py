"""``utils/profile_stage_b.py`` and ``utils/profile_step.py`` on the CPU at
tiny widths: the keys of their JSON lines, a finite scalar from every
component, the probe's honesty (each body consumes every output in
full), the FLOP shares, and the training batch's real frames."""

import json
import math

import numpy as np
import pytest
import torch

from matcha_tpu_torch import bench
from matcha_tpu_torch.models.config import tiny_config
from matcha_tpu_torch.utils import flops
from matcha_tpu_torch.utils import profile_stage_b as psb
from matcha_tpu_torch.utils import profile_step

B, TX, FINE = 2, 16, 64
STAGE_B_ARGS = ["--device", "cpu", "--tiny", "--batch", str(B), "--tx", str(TX), "--fine", str(FINE),
                "--k", "2", "--reps", "1"]


@pytest.fixture(scope="module")
def probes():
    cfg, vcfg = bench.configs("float32", tiny=True)
    synth = bench.build_synthesizer(cfg, vcfg, "cpu", tiny=True)
    return cfg, vcfg, psb.components(synth, cfg, vcfg, B, TX, FINE)


def test_profile_stage_b_prints_every_component(capsys):
    assert psb.main([*STAGE_B_ARGS, "--components", "all"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("batch", "tx", "fine", "coarse", "compute_dtype", "attention_backend", "method", "durations",
                "synthesis_flops", "device"):
        assert key in out
    assert out["device"]["platform"] == "cpu" and "not a device time" in out["method"]
    for name in psb.ALL_COMPONENTS:
        entry = out[name]
        assert math.isfinite(entry["scalar"]) and math.isfinite(entry["cpu_ms"])
        assert entry["device_ms"] is None and entry["tflop_per_s"] is None
        assert 0.0 <= entry["flops_share"] <= 1.0
    # the shares add up as the work does: 8 evaluations, then Vocos
    assert out["ode"]["flops"] == 8 * out["unet_eval"]["flops"]
    assert out["stage_b"]["flops"] == out["ode"]["flops"] + out["vocos"]["flops"]
    cfg, vcfg = bench.configs("bfloat16", tiny=True)
    assert out["synthesis_flops"] == flops.synthesis_flops(cfg, vcfg, B, TX, FINE)


def test_profile_stage_b_default_components_and_refusal(capsys):
    assert psb.main(STAGE_B_ARGS) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(psb.DEFAULT_COMPONENTS.split(",")) <= set(out) and "tblock_hi" not in out
    with pytest.raises(ValueError, match="unknown components"):
        psb.main([*STAGE_B_ARGS, "--components", "align,warp_drive"])


def _poisoned(fn):
    """``fn`` with a NaN written into the last element of every output."""
    def poisoned(acc, *args):
        outs = fn(acc, *args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        bad = []
        for o in outs:
            o = o.clone(memory_format=torch.contiguous_format)
            o.view(-1)[-1] = float("nan")
            bad.append(o)
        return tuple(bad)
    return poisoned


@pytest.mark.parametrize("name", psb.ALL_COMPONENTS)
def test_each_body_consumes_every_output(probes, name):
    """The honesty rule: a NaN anywhere in a component's output (here the
    last element of each output, which a slice-sum would miss) reaches
    the probe's scalar."""
    _, _, comps = probes
    fn, args, _ = comps[name]
    acc = torch.zeros(())
    with torch.inference_mode():
        assert math.isfinite(float(psb.consume(fn(acc, *args))))
        assert math.isnan(float(psb.consume(_poisoned(fn)(acc, *args))))


def test_block_flops_are_the_unets_parts(probes):
    cfg, _, comps = probes
    coarse = flops.coarse_frames(FINE)
    dim = cfg.decoder.channels[-1]
    block = flops.forward_flops(flops.transformer_block_products(cfg, B, coarse, dim))
    assert comps["tblock_hi"][2] == block
    assert comps["ffn_hi"][2] + comps["attn_hi"][2] < block
    assert comps["ffn_hi"][2] == comps["ffn_linear_hi"][2] == 2 * 2.0 * B * coarse * dim * 4 * dim
    assert comps["attn_hi"][2] == 2 * 2.0 * B * cfg.decoder.num_heads * coarse ** 2 * cfg.decoder.attention_head_dim


STEP_ARGS = ["--device", "cpu", "--tiny", "--batch", "3", "--tx", "12", "--frames", "32", "--iters", "2"]


@pytest.mark.parametrize("remat", [False, True])
def test_profile_step_prints_its_keys(capsys, remat):
    assert profile_step.main(STEP_ARGS + (["--remat"] if remat else [])) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    batch = profile_step.synthetic_batch(tiny_config(), 3, 12, 32)
    real = int(batch.y_lengths.sum())
    assert out["real_coarse_frames"] == real
    assert out["coarse_frames_per_s"] == pytest.approx(real / (out["wall_ms_per_step"] / 1e3), rel=1e-4)
    assert out["spread_ms"]["n"] == 2 and out["spread_ms"]["min"] <= out["wall_ms_per_step"] <= out["spread_ms"]["max"]
    assert out["flops_per_step"] == flops.train_step_flops(tiny_config(), 3, 12, 32)
    assert out["mfu_flops_source"] == "analytic" and out["remat"] is remat
    for key in ("peak_memory_gib", "device_trace", "mfu"):
        assert out[key] is None and key in out["not_measured"]
    assert math.isfinite(out["losses"]["first"]) and math.isfinite(out["losses"]["last"])
    assert out["device"]["platform"] == "cpu"


def test_synthetic_batch_fills_its_bucket():
    cfg = tiny_config()
    batch = profile_step.synthetic_batch(cfg, 8, 40, 64, seed=3)
    y_len, x_len = batch.y_lengths.numpy(), batch.x_lengths.numpy()
    assert y_len[-1] == 64 and np.all((y_len >= 60) & (y_len <= 64))
    np.testing.assert_array_equal(x_len, np.clip(y_len * 40 // 64, 1, 40))
    np.testing.assert_array_equal(batch.y_fine_lengths.numpy(), 2 * y_len)
    for k in range(8):  # padding is zero, real frames are not
        assert torch.all(batch.y[k, y_len[k]:] == 0) and torch.all(batch.x[k, x_len[k]:] == 0)
        assert torch.all(batch.y_fine[k, 2 * y_len[k]:] == 0) and torch.all(batch.x[k, :x_len[k]] > 0)
    with pytest.raises(ValueError, match="cannot align"):
        profile_step.synthetic_batch(cfg, 2, 200, 64)
