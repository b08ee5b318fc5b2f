"""Minimal dependency-free WAV I/O (mono 16-bit PCM).

The port's own copy of ``matcha_tpu/utils/audio_io.py``: the corpus-prep
tools only need plain RIFF/PCM handling, which stdlib ``wave`` + numpy
cover without soundfile/librosa.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Returns (float32 mono waveform in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        channels = f.getnchannels()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, sr


def write_wav(path: str | Path, wav: np.ndarray, sample_rate: int) -> None:
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def duration_seconds(path: str | Path) -> float:
    with wave.open(str(path), "rb") as f:
        return f.getnframes() / f.getframerate()
