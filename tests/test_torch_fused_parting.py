"""Where the port's fused and two-stage bf16 paths part, on the CPU.

At the hardware parity point (``utils/hw_parity``: ``MatchaConfig()`` +
``VocosConfig()``, speaker 2, the JAX tier's 40 ids, text bucket 64) the
two-stage path decodes at the fine bucket its durations pick, 256 (decoder
T=128), and the fused path at the bucket it predicts from the text, 512
(T=256).  The JAX package's two programs give bit-equal audio; the port's
bf16 audio differs by 0.13 dB on the CPU (0.10 on the card).  Run stage by
stage, the two paths are bit-equal through stage A, the prior on the valid
frames, and every module of the first U-Net evaluation up to the first
masked GroupNorm (``down_blocks.0.0.block1``'s).  Its statistics sum x²
over the whole bucket with the padded frames masked to zero, and torch's
CPU reduction groups the terms by the bucket's length: the sum of squares
rounds differently (6.1e-5 in about 1,000, half an fp32 ulp).  In fp32
that stays at the rounding level; in bf16 the next conv's cast turns it
into bf16 rounding flips, which the ODE amplifies at random weights.

These tests hold that: the inputs bit-equal, the first module whose
valid-frame output differs (if any does) a GroupNorm fed bit-equal inputs,
its outputs within 1e-6 of each other, fp32 audio at the MCD floor of the
JAX package's own pair (0.0072 dB, the floor of ``mcd_dtw``: below 0.01),
and the bf16 gap under the tier's bar ``FUSED_MCD_BAR_DB`` (0.15 dB).
"""

import numpy as np
import pytest
import torch

from matcha_tpu_torch.inference import align_prior, blended_scale_correction, pick_bucket
from matcha_tpu_torch.models.layers import GroupNorm
from matcha_tpu_torch.utils import hw_parity as hp
from matcha_tpu_torch.utils.mcd import mcd_dtw

MIX = [(hp.SPEAKER, 1.0)]


@pytest.fixture(scope="module")
def bf16_synth():
    return hp.build_synthesizer("cpu", "bfloat16")


def stage_a(synth):
    """Stage A at the parity point and the two paths' fine buckets."""
    ids = [int(i) for i in hp.phoneme_ids()]
    scale = blended_scale_correction(MIX)
    tx = pick_bucket(len(ids), synth.text_buckets)
    args = synth._stage_a_inputs([ids], [MIX], [scale], 1, tx)
    mu_x, durations, x_mask = synth.replicas[0].encode(*args)
    total = int(durations.sum())
    two_stage = pick_bucket(total, synth.mel_fine_buckets)
    fused = synth.predict_fine_bucket(tx, scale)
    return args, (mu_x, durations, x_mask), total, two_stage, fused


def first_evaluation(synth, enc, total, bucket):
    """Every estimator module's inputs and outputs, in call order, in the
    first U-Net evaluation of the decode at ``bucket``; the valid frames."""
    rep, est = synth.replicas[0], synth.model.decoder.estimator
    mu_x, durations, _ = enc
    mu_y, y_mask = align_prior(mu_x, durations, torch.tensor([total]), bucket)
    x = (mu_y + rep.noise(1, mu_y.shape[1]).to(mu_y.dtype)) * y_mask[..., None]
    records, hooks = [], []
    for name, mod in est.named_modules():
        if name:
            hooks.append(mod.register_forward_pre_hook(
                lambda m, inp, name=name: records.append((name, "in", m, [t.clone() for t in inp if torch.is_tensor(t)]))))
            hooks.append(mod.register_forward_hook(
                lambda m, inp, out, name=name: records.append((name, "out", m, [out.clone()] if torch.is_tensor(out) else []))))
    try:
        with torch.inference_mode():
            est(x, y_mask, mu_y, torch.zeros((1,)), masked_norm=True)
    finally:
        for h in hooks:
            h.remove()
    return records, mu_y, int(y_mask.sum())


def valid_frames(t: torch.Tensor, T: int, valid: int) -> torch.Tensor:
    """``t`` cut to the valid frames along its time axis (T, T/2 or T/4)."""
    for div in (1, 2, 4):
        if t.dim() >= 2 and t.shape[1] == T // div:
            return t[:, : -(-valid // div)]
    return t


def test_stage_a_and_prior_are_bit_equal(bf16_synth):
    """The fused path's stage A is the two-stage one's call (same text
    bucket); the prior at the two buckets agrees bit for bit on the valid
    frames."""
    synth = bf16_synth
    args, enc, total, two_stage, fused = stage_a(synth)
    assert (two_stage, fused) == (256, 512)
    again = synth.replicas[0].encode(*args)
    assert all(torch.equal(a, b) for a, b in zip(enc, again))
    mu_a, m_a = align_prior(enc[0], enc[1], torch.tensor([total]), two_stage)
    mu_b, m_b = align_prior(enc[0], enc[1], torch.tensor([total]), fused)
    valid = int(m_a.sum())
    assert valid == int(m_b.sum()) == (total + 1) // 2
    assert torch.equal(mu_a[:, :valid], mu_b[:, :valid])


def test_first_parting_is_a_masked_group_norm(bf16_synth):
    """In the first U-Net evaluation, every module's valid-frame inputs and
    outputs agree bit for bit up to the first that differs, and that one
    (if any) is a GroupNorm's output from bit-equal inputs, within 1e-6."""
    synth = bf16_synth
    _, enc, total, two_stage, fused = stage_a(synth)
    ra, mu_a, valid = first_evaluation(synth, enc, total, two_stage)
    rb, mu_b, _ = first_evaluation(synth, enc, total, fused)
    ta, tb = mu_a.shape[1], mu_b.shape[1]
    assert [r[:2] for r in ra] == [r[:2] for r in rb]
    for (name, kind, mod, xs), (_, _, _, ys) in zip(ra, rb):
        pairs = [(valid_frames(x, ta, valid), valid_frames(y, tb, valid)) for x, y in zip(xs, ys)]
        if all(torch.equal(x, y) for x, y in pairs):
            continue
        assert kind == "out" and isinstance(mod, GroupNorm), f"first parting at {name} ({kind}, {type(mod).__name__})"
        inputs = [r for r in ra if r[0] == name and r[1] == "in"][-1][3]
        inputs_b = [r for r in rb if r[0] == name and r[1] == "in"][-1][3]
        assert torch.equal(valid_frames(inputs[0], ta, valid), valid_frames(inputs_b[0], tb, valid))
        for x, y in pairs:
            assert float((x.float() - y.float()).abs().max() / x.float().abs().max()) <= 1e-6, name
        break


@pytest.mark.parametrize("dtype,bound", [("float32", 0.01), ("bfloat16", hp.FUSED_MCD_BAR_DB)])
def test_fused_against_two_stage_audio(dtype, bound, bf16_synth):
    """fp32: at the JAX package's floor; bf16: under the tier's bar."""
    synth = bf16_synth if dtype == "bfloat16" else hp.build_synthesizer("cpu", dtype)
    ids = hp.phoneme_ids()
    two = hp.synth_point("cpu", dtype, ids=ids, synth=synth)
    fused = hp.synth_point("cpu", dtype, fused=True, ids=ids, synth=synth)
    assert len(two["wav"]) == len(fused["wav"])
    assert np.isfinite(fused["wav"]).all()
    assert mcd_dtw(two["wav"], fused["wav"], basis="mel", device="cpu") < bound
