"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``sheeprl_tpu_torch/csrc/`` has a plain C
interface.  :class:`CudaLibrary` compiles it with ``nvcc`` for ``sm_90a``
into ``build/torch_kernels/`` (gitignored) on first use, once per content
hash of the source and flags, and loads it with ``ctypes``.  Nothing here
runs when a module is imported: a library is built by the first wrapper
that launches one of its kernels (or by :meth:`CudaLibrary.load` called
ahead, as ``chip_smoke.py`` does, one thread per library so the ``nvcc``
processes run side by side).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import torch

__all__ = ["BUILD_DIR", "CSRC", "CudaLibrary", "NVCC_FLAGS", "current_stream"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the port's kernels")


class CudaLibrary:
    """One kernel source, compiled once and loaded once per process.

    ``bind`` sets ``argtypes``/``restype`` on the loaded library.  After
    :meth:`load`, ``log`` holds the compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel), ``seconds`` the
    time the build took (0 when the library was already built) and
    ``path`` the built library."""

    def __init__(self, source: str, stem: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self.stem = stem
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.log = ""
        self.seconds = 0.0
        self.path: Optional[Path] = None

    def load(self) -> ctypes.CDLL:
        lib = self._lib  # loaded once: the wrappers' per-call path takes no lock
        if lib is not None:
            return lib
        with self._lock:
            if self._lib is not None:
                return self._lib
            src = self.source.read_bytes()
            digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            target = BUILD_DIR / f"{self.stem}_{digest}.so"
            t0 = time.perf_counter()
            if not target.exists():
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)], capture_output=True, text=True
                )
                self.log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    os.unlink(tmp)
                    raise RuntimeError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n{self.log}")
                os.replace(tmp, target)
            self.seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(str(target))
            self._bind(lib)
            self.path = target
            self._lib = lib
            return lib


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(device_index: int) -> int:
    """The current CUDA stream of a device, as the integer a C entry takes
    (PyTorch's raw-stream query where it has one: no stream object is made)."""
    if _raw_stream is not None:
        return _raw_stream(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream
