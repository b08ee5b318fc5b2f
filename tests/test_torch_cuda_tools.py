"""The port's voice-building tools on a card against the same tools on the CPU.

Every test here carries the ``cuda`` marker and skips where no CUDA device
exists.  This file imports torch, numpy and the port only, so it runs on a
machine without JAX; run it there without ``tests/conftest.py`` (which
imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda_tools.py -q -m cuda

Tolerances: log-mel (a float64 STFT and filterbank product on both: cuFFT
on the card, pocketfft on the CPU) max |Δ| 2e-3, as the CPU parity tests
hold the port against the JAX package; the StyleEncoder's outputs 1e-4 (fp32 convs,
cuDNN against the CPU's, TF32 off).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from matcha_tpu_torch.audio.mel import MelConfig, legacy_hifigan_mel, log_mel_spectrogram
from matcha_tpu_torch.models.style_encoder import StyleEncoder
from matcha_tpu_torch.utils.audio_io import read_wav

FIXTURES = Path(__file__).resolve().parent.parent / "mcd_validation"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["original_speaker_000.wav", "original_speaker_007.wav"])
@pytest.mark.parametrize("cfg", [MelConfig(), MelConfig().fine, MelConfig(mel_scale="slaney")],
                         ids=["coarse", "fine", "slaney"])
def test_log_mel_on_card_matches_cpu(card, name, cfg):
    wav, _ = read_wav(FIXTURES / name)
    w = torch.from_numpy(wav)
    got = log_mel_spectrogram(w.to(card), cfg)
    want = log_mel_spectrogram(w, cfg)
    assert got.is_cuda and got.shape == want.shape == (1 + len(wav) // cfg.hop_length, cfg.n_mels)
    assert (got.cpu() - want).abs().max().item() <= 2e-3
    legacy = legacy_hifigan_mel(w.to(card))
    assert (legacy.cpu() - legacy_hifigan_mel(w)).abs().max().item() <= 2e-3


@pytest.mark.cuda
def test_style_encoder_on_card_matches_cpu(card):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    style = StyleEncoder(100, 96)
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 300, 100)).astype(np.float32))
    mask = torch.ones(2, 300)
    mask[1, 200:] = 0
    with torch.no_grad():
        want = style(mel, mask)
        got = style.to(card)(mel.to(card), mask.to(card))
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max().item() <= 1e-4
