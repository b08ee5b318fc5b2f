"""Ogg/Opus encoding via the native C++ encoder.

Host-side counterpart of the reference's PyAV/libopus path
(reference: matcha/inference.py:300-320): mono 48 kbps Opus in an Ogg
container.  The encoder lives in the library that ``data/native_loader.py``
builds from ``native/src`` (as the JAX package takes its library from its
native loader); it ``dlopen``s the system libopus when it encodes.
"""

from __future__ import annotations

import ctypes

import numpy as np

from matcha_tpu_torch.data import native_loader


def _load():
    """The native library with the encoder's argument types declared, or
    None where the library does not build or load here."""
    if not native_loader.available():
        return None
    lib = native_loader.load_library()
    fn = lib.mtpu_opus_ogg_encode
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


def available() -> bool:
    return _load() is not None


def encode_opus_ogg(
    pcm: np.ndarray, sample_rate: int = 24000, bitrate: int = 48000
) -> bytes:
    """int16 mono PCM → Ogg/Opus bytes."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native opus encoder unavailable (the native library did not build: needs g++)"
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
        why = " (libopus.so.0 could not be loaded: install libopus)" if rc == -1 else ""
        raise RuntimeError(f"opus encode failed: {rc}{why}")
    try:
        return bytes(
            bytearray(ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8 * n.value)).contents)
        )
    finally:
        lib.mtpu_opus_ogg_free(out)


def waveform_to_opus_ogg(wav: np.ndarray, sample_rate: int = 24000) -> bytes:
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    return encode_opus_ogg(pcm, sample_rate=sample_rate)
