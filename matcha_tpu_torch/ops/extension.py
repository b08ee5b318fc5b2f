"""Build the hand-written CUDA kernels and count their launches.

The kernels live as sources under ``ops/csrc/`` and are compiled on first
use, on the machine that runs them, with ``torch.utils.cpp_extension.load``
for Hopper (``sm_90a``).  The build goes to ``ops/build/`` inside the
package (listed in ``.gitignore``); importing this module builds nothing,
so the CPU-only test suite imports every module of the port without a CUDA
toolkit.
"""

from __future__ import annotations

import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# every kernel source of the port, built into one extension so the
# PyTorch-header binding file compiles once
SOURCES = ("masked_attention_binding.cpp", "masked_attention_fwd.cu",
           "masked_attention_bwd.cu", "mas.cu")
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")

_build_lock = threading.Lock()
_extension = None


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
                name="matcha_tpu_torch_kernels",
                sources=[str(CSRC / s) for s in SOURCES],
                build_directory=str(BUILD_DIR),
                extra_cflags=["-O3", "-std=c++17"],
                extra_cuda_cflags=list(CUDA_FLAGS),
                verbose=False,
            )
        return _extension


class LaunchCounter:
    """Launches of one kernel: its wrapper adds one per launch, nowhere else.

    Thread-safe, since the serving batcher runs groups on several threads.
    """

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def launches(self) -> int:
        return self._n
