"""Build-at-first-use for the hand-written CUDA kernels under ``csrc/``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``; nothing includes
PyTorch's headers, so a build takes seconds.  Libraries land in
``build/kernels/`` at the repo root, named by a hash of the source, so an
edited source is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return nvcc


class CudaKernel:
    """One ``csrc/*.cu`` source, its C entry point, and a launch counter.
    Several entry points of one source share its library.

    ``launches`` counts calls of the C entry point that reached the card;
    the wrapper that launches the kernel adds to it (``count``), and
    nothing else does.  ``stream_launches`` splits the count by the CUDA
    stream (its ``cudaStream_t`` as an int) each launch was enqueued on.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.stream_launches: Dict[int, int] = {}
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._fn: Optional[ctypes._CFuncPtr] = None
        self._lock = threading.Lock()

    def count(self, stream: int) -> None:
        """One launch that reached the card, on ``stream``."""
        with self._lock:
            self.launches += 1
            self.stream_launches[stream] = self.stream_launches.get(stream, 0) + 1

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}.{digest}.so"

    def build(self) -> Path:
        """Compile the source unless a library of this exact source exists;
        the ``-Xptxas -v`` report (registers, shared memory, spills) is kept
        in ``build_log`` and beside the library."""
        lib = self.library_path()
        log = lib.with_suffix(".log")
        if lib.exists():
            self.build_log = log.read_text() if log.exists() else ""
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n{proc.stderr}")
        self.build_log = proc.stdout + proc.stderr
        log.write_text(self.build_log)
        os.replace(tmp, lib)
        return lib

    def library(self) -> ctypes.CDLL:
        """The loaded library, built on first use."""
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(str(self.build()))
            return self._lib

    def fn(self):
        """The C entry point."""
        if self._fn is None:
            fn = getattr(self.library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn
