"""The port's voice-building tools on a card against the same tools on the
CPU, and its measuring modules on a card.

Every test here carries the ``cuda`` marker and skips where no CUDA device
exists.  This file imports torch, numpy and the port only, so it runs on a
machine without JAX; run it there without ``tests/conftest.py`` (which
imports JAX):

    python -m pytest --noconftest tests/test_torch_cuda_tools.py -q -m cuda

Tolerances: log-mel (a float64 STFT and filterbank product on both: cuFFT
on the card, pocketfft on the CPU) max |Δ| 2e-3, as the CPU parity tests
hold the port against the JAX package; the StyleEncoder's outputs 1e-4 (fp32 convs,
cuDNN against the CPU's, TF32 off).  ``utils/probe.inner_repeat`` captures
a CUDA graph (and refuses what cannot be captured); ``utils/profiling.
trace`` + ``utils/trace_analysis.device_stats`` read device time off a
real trace.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from matcha_tpu_torch.audio.mel import MelConfig, legacy_hifigan_mel, log_mel_spectrogram
from matcha_tpu_torch.models.style_encoder import StyleEncoder
from matcha_tpu_torch.utils import probe, profiling, trace_analysis
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


@pytest.mark.cuda
def test_inner_repeat_captures_a_graph_on_the_card(card):
    x = torch.randn(2048, 2048, device=card)

    def fn(acc, x):
        return (x @ (x + acc)).float().sum() * 1e-12

    out = probe.inner_repeat(fn, x, k=4, reps=5)
    assert out["device_ms"] > 0.0


@pytest.mark.cuda
def test_inner_repeat_refuses_what_cannot_be_captured(card):
    x = torch.randn(8, device=card)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        probe.inner_repeat(lambda acc, x: acc + float(x.sum().item()), x, k=2, reps=1)
    # the process's random draws on the card still work after the failed capture
    assert torch.randn(4, device=card).isfinite().all()


@pytest.mark.cuda
def test_trace_on_the_card_reads_device_time(card, tmp_path):
    x = torch.randn(1024, 1024, device=card)
    with profiling.trace(str(tmp_path)):
        for _ in range(5):
            x = x @ x * 1e-3
    stats = trace_analysis.device_stats(tmp_path)
    assert stats["device_busy_ms"] > 0.0 and stats["device_events"] >= 5
    assert stats["device_busy_ms"] <= stats["wall_span_ms"]
