"""In-process MP3 encoding via ctypes → libmp3lame (C).

Host-side C-library work, exactly like the reference
(reference: matcha/utils/mp3_converter.py:1-75): VBR encode of 16-bit mono
PCM without shelling out to ffmpeg.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

_lame = None


def _load_lame():
    global _lame
    if _lame is not None:
        return _lame
    name = ctypes.util.find_library("mp3lame") or "libmp3lame.so.0"
    lib = ctypes.CDLL(name)
    lib.lame_init.restype = ctypes.c_void_p
    for fn, args in {
        "lame_set_in_samplerate": (ctypes.c_void_p, ctypes.c_int),
        "lame_set_num_channels": (ctypes.c_void_p, ctypes.c_int),
        "lame_set_VBR": (ctypes.c_void_p, ctypes.c_int),
        "lame_set_VBR_q": (ctypes.c_void_p, ctypes.c_int),
        "lame_set_quality": (ctypes.c_void_p, ctypes.c_int),
        "lame_init_params": (ctypes.c_void_p,),
        "lame_close": (ctypes.c_void_p,),
    }.items():
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    lib.lame_encode_buffer.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_short),
        ctypes.POINTER(ctypes.c_short),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
    ]
    lib.lame_encode_buffer.restype = ctypes.c_int
    lib.lame_encode_flush.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
    ]
    lib.lame_encode_flush.restype = ctypes.c_int
    _lame = lib
    return lib


VBR_MTRH = 4  # lame's vbr_mtrh mode, the modern VBR default


def encode_mp3(
    pcm: np.ndarray,
    sample_rate: int = 24000,
    vbr_quality: int = 5,
    algorithm_quality: int = 5,
) -> bytes:
    """Encode int16 mono PCM to MP3 bytes (VBR)."""
    pcm = np.ascontiguousarray(pcm, dtype=np.int16).ravel()
    lame = _load_lame()
    gfp = lame.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lame.lame_set_in_samplerate(gfp, sample_rate)
        lame.lame_set_num_channels(gfp, 1)
        lame.lame_set_VBR(gfp, VBR_MTRH)
        lame.lame_set_VBR_q(gfp, vbr_quality)
        lame.lame_set_quality(gfp, algorithm_quality)
        if lame.lame_init_params(gfp) < 0:
            raise RuntimeError("lame_init_params failed")

        n = len(pcm)
        out_size = int(1.25 * n + 7200)
        out = (ctypes.c_ubyte * out_size)()
        src = pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
        written = lame.lame_encode_buffer(gfp, src, src, n, out, out_size)
        if written < 0:
            raise RuntimeError(f"lame_encode_buffer error {written}")
        data = bytes(out[:written])
        flushed = lame.lame_encode_flush(gfp, out, out_size)
        if flushed > 0:
            data += bytes(out[:flushed])
        return data
    finally:
        lame.lame_close(gfp)


def waveform_to_mp3(wav: np.ndarray, sample_rate: int = 24000) -> bytes:
    """float waveform in [-1, 1] → MP3 bytes."""
    pcm = np.clip(wav, -1.0, 1.0)
    return encode_mp3((pcm * 32767.0).astype(np.int16), sample_rate=sample_rate)
