"""Build the hand-written CUDA kernels and count their launches.

The kernels live as sources under ``ops/csrc/`` and are compiled on first
use, on the machine that runs them, with ``torch.utils.cpp_extension.load``
for Hopper (``sm_90a``).  The build goes to ``ops/build/`` inside the
package (listed in ``.gitignore``); importing this module builds nothing,
so the CPU-only test suite imports every module of the port without a CUDA
toolkit.  ``load`` rebuilds when a listed source changes but not when a
header they include does, so the extension's name carries a hash of every
source and header it builds from: an edit to any of them builds anew.
"""

from __future__ import annotations

import hashlib
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# every kernel source of the port, built into one extension so the
# PyTorch-header binding file compiles once
SOURCES = ("masked_attention_binding.cpp", "masked_attention_fwd.cu",
           "masked_attention_bwd.cu", "mas.cu", "adamw.cu", "dit_fused.cu")
HEADERS = ("hopper.cuh",)
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")

_build_lock = threading.Lock()
_extension = None


def extension_name() -> str:
    """``matcha_tpu_torch_kernels_`` + 12 hex digits of the sources' and
    headers' contents."""
    digest = hashlib.sha256()
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    return "matcha_tpu_torch_kernels_" + digest.hexdigest()[:12]


def kernels():
    """The compiled extension module; builds it on the first call.

    Raises whatever the build raises: no caller falls back to a plain
    version when a kernel cannot be built.
    """
    global _extension
    with _build_lock:
        if _extension is None:
            from torch.utils.cpp_extension import load

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _extension = load(
                name=extension_name(),
                sources=[str(CSRC / s) for s in SOURCES],
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O3", "-std=c++17"],
                extra_cuda_cflags=list(CUDA_FLAGS),
                verbose=False,
            )
        return _extension


class LaunchCounter:
    """Launches of one kernel: its wrapper adds one per launch, nowhere else,
    with the launch's signature (shapes, dtype, options), so that a check
    can hold the kernel against its plain version at every signature a
    path launched it at.

    Thread-safe, since the serving batcher runs groups on several threads.
    """

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._signatures: set[tuple] = set()
        self._lock = threading.Lock()

    def add(self, signature: tuple) -> None:
        with self._lock:
            self._n += 1
            self._signatures.add(signature)

    def reset(self) -> None:
        with self._lock:
            self._n = 0
            self._signatures.clear()

    @property
    def launches(self) -> int:
        return self._n

    @property
    def signatures(self) -> list[tuple]:
        """The distinct signatures launched since the last ``reset``, sorted."""
        with self._lock:
            return sorted(self._signatures)
