"""Ogg/Opus encoding via the native C++ encoder (libmatcha_native.so).

Host-side counterpart of the reference's PyAV/libopus path
(reference: matcha/inference.py:300-320): mono 48 kbps Opus in an Ogg
container.  Requires ``make -C native`` and a system libopus.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np

# the native library the repository builds under native/ (make -C native)
_LIB_PATHS = [
    Path(__file__).resolve().parent.parent.parent / "native" / "libmatcha_native.so",
]


@lru_cache(maxsize=1)
def _load():
    for p in _LIB_PATHS:
        if p.exists():
            lib = ctypes.CDLL(str(p))
            try:
                fn = lib.mtpu_opus_ogg_encode
            except AttributeError:
                return None
            fn.argtypes = [
                ctypes.POINTER(ctypes.c_int16),
                ctypes.c_int64,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int64),
            ]
            fn.restype = ctypes.c_int
            lib.mtpu_opus_ogg_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            return lib
    return None


def available() -> bool:
    return _load() is not None


def encode_opus_ogg(
    pcm: np.ndarray, sample_rate: int = 24000, bitrate: int = 48000
) -> bytes:
    """int16 mono PCM → Ogg/Opus bytes."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native opus encoder unavailable (make -C native; needs libopus)"
        )
    pcm = np.ascontiguousarray(pcm, dtype=np.int16).ravel()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_int64()
    rc = lib.mtpu_opus_ogg_encode(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        len(pcm),
        sample_rate,
        bitrate,
        ctypes.byref(out),
        ctypes.byref(n),
    )
    if rc != 0:
        raise RuntimeError(f"opus encode failed: {rc}")
    try:
        return bytes(
            bytearray(ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8 * n.value)).contents)
        )
    finally:
        lib.mtpu_opus_ogg_free(out)


def waveform_to_opus_ogg(wav: np.ndarray, sample_rate: int = 24000) -> bytes:
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    return encode_opus_ogg(pcm, sample_rate=sample_rate)
