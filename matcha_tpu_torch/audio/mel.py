"""Log-mel spectrogram extraction in PyTorch, on any device.

Counterpart of ``matcha_tpu/audio/mel.py`` (the Vocos-24k training
extractor: torchaudio ``MelSpectrogram(center=True, power=1,
mel_scale="htk", norm=None)``):

  * waveform trimmed to a multiple of ``hop_length``
  * reflect-padded by ``n_fft//2`` on both sides (center framing), so
    frames = 1 + T // hop
  * periodic Hann window, magnitude (power=1) spectrum
  * HTK-scale triangular mel filterbank, no normalization
  * ``log(clamp(mel, 1e-7))``

The JAX version frames by a gather and calls ``jnp.fft.rfft``; no Pallas
kernel is involved, so here it is ``torch.stft`` (cuFFT on the card) and one
(frames, n_freqs) x (n_freqs, n_mels) matmul.  Both run in float64: an
fp32 FFT's rounding is relative to the frame's loudest bins, and bins 80 dB
below them (16-bit noise floor under voiced frames) came out 1.9e-3 from
the exact log-mel on the card, at the edge of the 2e-3 the frontend is
held to; the filterbank product in float64 needs no TF32 switch and costs
nothing beside the FFT.  The filterbanks are numpy, the port's own copy of
the JAX package's (float32 values, as the JAX package and torchaudio keep
them).  Output is time-major ``(..., frames, n_mels)`` fp32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import numpy as np
import torch


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 100
    f_min: float = 0.0
    f_max: float = 12000.0
    log_eps: float = 1e-7
    # "htk" (Vocos-24k production) or "slaney" (librosa semantics: slaney
    # scale + slaney area normalization)
    mel_scale: str = "htk"

    @property
    def fine(self) -> "MelConfig":
        """Fine-resolution (hop/2) variant used by the encoder and MAS."""
        return replace(self, hop_length=self.hop_length // 2)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window(periodic=True))."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3.0)
    log_region = f >= 1000.0
    return np.where(
        log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / np.log(6.4) * 27.0, mel
    )


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3.0)
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), f)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, f_min: float, f_max: float,
                   mel_scale: str = "htk") -> np.ndarray:
    """(n_freqs, n_mels) triangular filterbank, float32.

    ``htk``: torchaudio ``melscale_fbanks(mel_scale='htk', norm=None)``.
    ``slaney``: librosa's slaney scale with slaney (2/bandwidth) area
    normalization.  Cached: callers must not write into the result.
    """
    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    if mel_scale == "htk":
        to_mel, to_hz = _hz_to_mel_htk, _mel_to_hz_htk
    elif mel_scale == "slaney":
        to_mel, to_hz = _hz_to_mel_slaney, _mel_to_hz_slaney
    else:
        raise ValueError(f"Unknown mel_scale {mel_scale!r}")
    f_pts = to_hz(np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if mel_scale == "slaney":
        fb *= (2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


def _window(win_length: int, n_fft: int, device) -> torch.Tensor:
    """The Hann window zero-padded to n_fft, centred (as torch.stft pads it)."""
    w = np.zeros((n_fft,), np.float64)
    lpad = (n_fft - win_length) // 2
    w[lpad: lpad + win_length] = hann_window(win_length)
    return torch.from_numpy(w).to(device)


def _stft(wav: torch.Tensor, n_fft: int, hop: int, win_length: int, center: bool) -> torch.Tensor:
    """(..., T) → complex128 (..., frames, n_fft//2 + 1)."""
    lead = wav.shape[:-1]
    x = wav.reshape(-1, wav.shape[-1]).double()
    spec = torch.stft(x, n_fft, hop_length=hop, win_length=n_fft,
                      window=_window(win_length, n_fft, x.device), center=center,
                      pad_mode="reflect", return_complex=True)
    spec = spec.transpose(-1, -2)
    return spec.reshape(*lead, *spec.shape[-2:])


def _log_mel(mag: torch.Tensor, fb: np.ndarray, eps: float) -> torch.Tensor:
    """float64 magnitudes x the float32 filterbank, in float64 → fp32 log-mel."""
    mel = torch.matmul(mag, torch.from_numpy(fb).to(mag.device, torch.float64))
    return torch.log(torch.clamp(mel, min=eps)).float()


def stft_magnitude(wav: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Magnitude STFT of a (..., T) waveform → (..., 1 + T // hop, n_freqs).

    Centered framing: reflect-pad by n_fft//2.
    """
    return _stft(wav, cfg.n_fft, cfg.hop_length, cfg.win_length, center=True).abs().float()


def log_mel_spectrogram(wav: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(..., T) waveform → (..., T // hop + 1, n_mels) log-mel features.

    The waveform is trimmed to a multiple of ``hop_length`` first, as the
    Vocos-24k extractor does.
    """
    t = (wav.shape[-1] // cfg.hop_length) * cfg.hop_length
    mag = _stft(wav[..., :t], cfg.n_fft, cfg.hop_length, cfg.win_length, center=True).abs()
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.f_min, cfg.f_max,
                        cfg.mel_scale)
    return _log_mel(mag, fb, cfg.log_eps)


def legacy_hifigan_mel(wav: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                       sample_rate: int = 22050, hop_length: int = 256, win_length: int = 1024,
                       f_min: float = 0.0, f_max: float = 8000.0) -> torch.Tensor:
    """Legacy HiFiGAN-style mel (the reference's ``utils/audio.py:44-82``).

    Uncentered STFT after a manual reflect pad of (n_fft-hop)//2 per side,
    magnitude sqrt(re² + im² + 1e-9), slaney-scale/slaney-norm filterbank,
    log(clamp(x, 1e-5)).  (..., T) → (..., frames, num_mels).
    """
    pad = (n_fft - hop_length) // 2
    lead = wav.shape[:-1]
    y = torch.nn.functional.pad(wav.reshape(-1, 1, wav.shape[-1]).double(), (pad, pad),
                                mode="reflect")
    spec = _stft(y.reshape(*lead, y.shape[-1]), n_fft, hop_length, win_length, center=False)
    mag = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-9)
    fb = mel_filterbank(sample_rate, n_fft, num_mels, f_min, f_max, "slaney")
    return _log_mel(mag, fb, 1e-5)
