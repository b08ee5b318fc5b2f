"""ctypes binding for the repository's native C++ batch loader.

The port's counterpart of ``matcha_tpu/data/native_loader.py``: the same C
API (``mtpu_mel_length``, ``mtpu_fill_batch``), and the same library, which
also carries the Ogg/Opus encoder that ``utils/opus_converter.py`` binds.
The port builds that library itself from the repository's sources,
``native/src/dataloader.cpp`` and ``native/src/opusogg.cpp``, with the flags
of ``native/Makefile``, at first use, into ``matcha_tpu_torch/ops/build/``
(listed in ``.gitignore``); it never writes into ``native/``.  The file's
name carries a hash of the sources and flags, so an edit to either builds
anew.  Ranks started together (``torchrun``) may build at once: each
compiles to a name of its own and renames it into place, which is atomic.
The encoder ``dlopen``s libopus when it encodes, so a machine without
libopus still loads the loader.

``fill_batch`` reads B channel-major ``(n_mels, T)`` float32 ``.npy`` caches
(time-major and Fortran-order ones too) into a zero-padded, time-major
``(B, t_pad, n_mels)`` batch on a C++ thread pool, without the GIL.  Given
``out=``, a contiguous float32 CPU tensor (pinned, when the batch goes to
the card), it fills that tensor in place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from matcha_tpu_torch.ops.extension import LaunchCounter

NATIVE_SRC = Path(__file__).resolve().parent.parent.parent / "native" / "src"
BUILD_DIR = Path(__file__).resolve().parent.parent / "ops" / "build"
SOURCES = ("dataloader.cpp", "opusogg.cpp")
# native/Makefile: CXXFLAGS (without -Wall), then the link line's flags
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared", "-pthread")
LINK_FLAGS = ("-ldl",)

# calls of mtpu_fill_batch, so a run can show that a path took the library
fill_batch_count = LaunchCounter("native_fill_batch")

_lock = threading.Lock()
_library = None
_error: Exception | None = None  # the first build or load failure, raised again


def library_path() -> Path:
    """``ops/build/libmatcha_native_`` + 12 hex digits of the sources' and
    flags' contents + ``.so``."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((NATIVE_SRC / name).read_bytes())
    return BUILD_DIR / f"libmatcha_native_{digest.hexdigest()[:12]}.so"


def build_library() -> Path:
    """Compile the library with ``g++`` unless it is already built; returns
    its path.  Raises ``RuntimeError`` with the compiler's output when the
    build fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_SRC / s) for s in SOURCES), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError(f"cannot build the native loader: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native loader failed ({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.mtpu_mel_length.argtypes = [ctypes.c_char_p]
    lib.mtpu_mel_length.restype = ctypes.c_long
    lib.mtpu_fill_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.mtpu_fill_batch.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded library; builds it on the first call.  Raises what the
    build or ``dlopen`` raises, and raises that again on every later call
    without building anew."""
    global _library, _error
    with _lock:
        if _library is None:
            if _error is not None:
                raise _error
            try:
                _library = _bind(ctypes.CDLL(str(build_library())))
            except (OSError, RuntimeError) as exc:
                _error = exc
                raise
        return _library


def loaded() -> bool:
    """True once ``load_library`` has succeeded in this process."""
    return _library is not None


def available() -> bool:
    """True when the library builds and loads here (tried once a process)."""
    try:
        load_library()
    except (OSError, RuntimeError):
        return False
    return True


def mel_length(path: str | Path) -> int:
    """Frame count of a channel-major ``(n_mels, T)`` cache from its header
    alone: the second dimension."""
    n = load_library().mtpu_mel_length(str(path).encode())
    if n < 0:
        raise IOError(f"mtpu_mel_length({path}) failed: {n}")
    return int(n)


def fill_batch(paths: list[str | Path], t_pad: int, n_mels: int, threads: int = 0,
               out: torch.Tensor | None = None):
    """Load B mel caches into a zero-padded ``(B, t_pad, n_mels)`` batch.

    Returns ``(batch, lengths)``: a float32 numpy array, or ``out`` filled in
    place, and the int32 frame counts (each clipped to ``t_pad``)."""
    lib = load_library()
    b = len(paths)
    if out is None:
        batch = np.empty((b, t_pad, n_mels), np.float32)
        ptr = batch.ctypes.data
    else:
        if (out.device.type != "cpu" or out.dtype != torch.float32 or not out.is_contiguous()
                or tuple(out.shape) != (b, t_pad, n_mels)):
            raise ValueError(f"out must be a contiguous float32 CPU tensor of shape {(b, t_pad, n_mels)}, "
                             f"got {out.dtype} {tuple(out.shape)} on {out.device}")
        batch, ptr = out, out.data_ptr()
    lens = np.zeros((b,), np.int32)
    c_paths = (ctypes.c_char_p * b)(*[str(p).encode() for p in paths])
    rc = lib.mtpu_fill_batch(c_paths, b, ptr, t_pad, n_mels, lens.ctypes.data, threads)
    if rc != 0:
        raise IOError(f"mtpu_fill_batch failed with {rc}")
    fill_batch_count.add((b, t_pad, n_mels))
    return batch, lens
