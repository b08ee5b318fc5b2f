"""The port's fused and two-stage bf16 paths do not part, on the CPU.

At the hardware parity point (``utils/hw_parity``: ``MatchaConfig()`` +
``VocosConfig()``, speaker 2, the JAX tier's 40 ids, text bucket 64) the
two-stage path decodes at the fine bucket its durations pick, 256 (decoder
T=128), and the fused path at the bucket it predicts from the text, 512
(T=256).  The JAX package's two programs give bit-equal audio (0.0072 dB,
the floor of ``mcd_dtw``).  The port's once parted at the first masked
GroupNorm, whose statistics summed over the whole bucket and so rounded
differently at each padded length (0.13 dB in bf16 on the CPU, 0.10 on the
card); ``models/layers.valid_frame_means`` now sums the valid frames in an
order the padding cannot change.

These tests hold that: stage A and the prior bit-equal, no module of any
U-Net evaluation of the decode parting on the valid frames (bit for bit,
with the fp32 and with the bf16 norm statistics), bit-equal bf16 audio,
and fp32 audio at the floor of the JAX package's own pair (below 0.01 dB).
They run, as the whole suite does, with torch on one thread
(``tests/conftest.py``): on some other thread counts (2 and 4 on an 8-core
host) the CPU's bf16 matmuls split their work by shape and part the two
decodes at a Linear or a 1x1 conv (``python -m
matcha_tpu_torch.utils.hw_parity --device cpu --walk`` names the module at
the process's thread count).
"""

import numpy as np
import pytest
import torch

from matcha_tpu_torch.inference import align_prior
from matcha_tpu_torch.utils import hw_parity as hp


@pytest.fixture(scope="module")
def bf16_synth():
    return hp.build_synthesizer("cpu", "bfloat16")


def test_stage_a_and_prior_are_bit_equal(bf16_synth):
    """The fused path's stage A is the two-stage one's call (same text
    bucket); the prior at the two buckets agrees bit for bit on the valid
    frames."""
    synth = bf16_synth
    args, enc, total, two_stage, fused = hp.stage_a(synth)
    assert (two_stage, fused) == (256, 512)
    again = synth.replicas[0].encode(*args)
    assert all(torch.equal(a, b) for a, b in zip(enc, again))
    mu_a, m_a = align_prior(enc[0], enc[1], torch.tensor([total]), two_stage)
    mu_b, m_b = align_prior(enc[0], enc[1], torch.tensor([total]), fused)
    valid = int(m_a.sum())
    assert valid == int(m_b.sum()) == (total + 1) // 2
    assert torch.equal(mu_a[:, :valid], mu_b[:, :valid])


@pytest.mark.parametrize("bf16_norm_stats", [False, True])
def test_no_module_parts_on_the_valid_frames(bf16_norm_stats, bf16_synth):
    """In every U-Net evaluation of the decodes at T=128 and T=256, every
    module's inputs and outputs agree bit for bit on the valid frames, and
    so do the mels."""
    synth = hp.build_synthesizer("cpu", "bfloat16", bf16_norm_stats=True) if bf16_norm_stats else bf16_synth
    walk = hp.bucket_walk(synth)
    assert walk["decoder_T"] == [128, 256]
    assert walk["evaluations"] == 8 and walk["records"] > 8 * 100
    assert walk["first_parting"] is None, walk["first_parting"]
    assert walk["mel_equal"]


@pytest.mark.parametrize("dtype,bf16_norm_stats", [("float32", False), ("bfloat16", False), ("bfloat16", True)],
                         ids=["float32", "bfloat16", "bfloat16-norm-stats"])
def test_fused_against_two_stage_audio(dtype, bf16_norm_stats, bf16_synth):
    """fp32: at the floor of the JAX package's own pair, below 0.01 dB (the
    CPU library's fp32 conv parts the two decodes at the rounding level);
    bf16: bit-equal audio, as the JAX package's two bf16 programs give.  An
    MCD bound cannot say more: ``mcd_dtw`` reads 0.004–0.011 dB for equal
    audio, its distances coming from |a|² + |b|² − 2ab."""
    if dtype == "bfloat16" and not bf16_norm_stats:
        synth = bf16_synth
    else:
        synth = hp.build_synthesizer("cpu", dtype, bf16_norm_stats=bf16_norm_stats)
    pair = hp.fused_pair("cpu", dtype, synth)
    assert pair["wav_samples"][0] == pair["wav_samples"][1]
    assert np.isfinite(pair["wav_max_abs_diff"])
    if dtype == "float32":
        assert pair["mcd_db"] < 0.01
    else:
        assert pair["wav_max_abs_diff"] == 0.0
        assert pair["mcd_db"] < hp.FUSED_MCD_BAR_DB
