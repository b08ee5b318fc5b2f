"""Silence measurement and normalization for corpus wavs.

The port's own copy of ``matcha_tpu/utils/silence.py`` (same flags, same output);
it imports nothing of the JAX package.

Shared RMS-window machinery behind two CLIs:

  python -m matcha_tpu_torch.utils.measure_silence    — per-speaker leading/
      trailing silence statistics at -60/-90 dB (10 ms windows)
  python -m matcha_tpu_torch.utils.normalize_silence  — idempotently rebuild each
      wav as ``lead_ms of zeros + speech + trail_ms of zeros``

Silence-normalized corpora give MAS a stable amount of silence to assign to
the injected edge space tokens (reference: matcha/utils/normalize_silence.py:7-27
documents the motivation; measure: matcha/utils/measure_silence.py).
"""

from __future__ import annotations

import numpy as np

WINDOW_MS = 10.0


def rms_windows(wav: np.ndarray, sample_rate: int) -> np.ndarray:
    win = int(WINDOW_MS / 1000.0 * sample_rate)
    n = len(wav) // win
    if n == 0:
        return np.zeros((0,), np.float32)
    return np.sqrt(
        np.mean(np.square(wav[: n * win].reshape(n, win)), axis=1)
    )


def silence_bounds(
    wav: np.ndarray, sample_rate: int, threshold_db: float = -60.0
) -> tuple[int, int]:
    """(leading_windows, trailing_windows) below threshold."""
    return bounds_from_rms(rms_windows(wav, sample_rate), threshold_db)


def bounds_from_rms(
    rms: np.ndarray, threshold_db: float
) -> tuple[int, int]:
    """silence_bounds on a precomputed RMS grid — lets multi-threshold
    callers (measure_silence's -60/-90 dual report) window the wav once."""
    thresh = 10.0 ** (threshold_db / 20.0)
    silent = rms < thresh
    loud = np.flatnonzero(~silent)
    if loud.size == 0:
        return len(silent), 0  # all-silent: count it all as leading
    lead = int(loud[0])
    trail = len(silent) - 1 - int(loud[-1])
    return lead, trail


def normalize_silence(
    wav: np.ndarray,
    sample_rate: int,
    lead_ms: float = 200.0,
    trail_ms: float = 800.0,
    threshold_db: float = -60.0,
) -> np.ndarray:
    """Return ``zeros(lead) + speech + zeros(trail)``.

    Idempotent: re-running on an already-normalized wav reproduces it
    bit-for-bit (integer window arithmetic, pure zero padding).
    """
    win = int(WINDOW_MS / 1000.0 * sample_rate)
    lead_w, trail_w = silence_bounds(wav, sample_rate, threshold_db)
    start = lead_w * win
    end = len(wav) - trail_w * win
    speech = wav[start:end]
    lead = np.zeros(int(lead_ms / 1000.0 * sample_rate), wav.dtype)
    trail = np.zeros(int(trail_ms / 1000.0 * sample_rate), wav.dtype)
    return np.concatenate([lead, speech, trail])
