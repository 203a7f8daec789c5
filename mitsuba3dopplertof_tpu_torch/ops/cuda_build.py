"""Build the port's CUDA sources (``csrc/*.cu``) with nvcc into shared
libraries with a plain C interface, and load them with ctypes.

Each source builds at first use into ``_build/`` (ignored by git), keyed by
a hash of the source and the flags, so a changed source rebuilds and an
unchanged one loads at once. ``build_all`` starts one nvcc per source at
the same time and waits for all of them. Every file is built with
``--fmad=false`` and without fast math: no product and sum fuse into an FMA,
so a kernel rounds each operation as its plain PyTorch version does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time as _time
from pathlib import Path
from typing import Callable, Iterable, Optional

PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels (csrc/*.cu)")


class CudaLibrary:
    """One ``csrc/<name>.cu`` built into ``_build/<name>_<hash>.so``.
    ``bind(lib)`` sets the argument and result types of its C functions."""

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = PKG / "csrc" / f"{name}.cu"
        self._bind = bind
        self.lib: Optional[ctypes.CDLL] = None
        self.log = ""            # nvcc's output of the last build (ptxas -v)
        self.seconds = 0.0       # wall seconds of the last build
        self._proc = None
        self._tmp = None
        self._t0 = 0.0

    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes()
                           + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}_{h}.so"

    def start(self) -> None:
        """Start nvcc in the background if the library is missing."""
        if self.lib is not None or self._proc is not None or \
                self.path().exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, self._tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        self._t0 = _time.perf_counter()
        self._proc = subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", self._tmp, str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def load(self) -> ctypes.CDLL:
        """Build (or wait for the build started by ``start``) and load."""
        if self.lib is not None:
            return self.lib
        self.start()
        so = self.path()
        if self._proc is not None:
            out, _ = self._proc.communicate()
            self.seconds = _time.perf_counter() - self._t0
            self.log = out or ""
            rc, self._proc = self._proc.returncode, None
            if rc != 0:
                os.unlink(self._tmp)
                raise RuntimeError(f"nvcc failed on {self.source.name}:\n"
                                   f"{self.log}")
            os.replace(self._tmp, so)
        lib = ctypes.CDLL(str(so))
        self._bind(lib)
        self.lib = lib
        return lib


def build_all(libs: Iterable[CudaLibrary]) -> None:
    """Build every library, one nvcc per source, all started together."""
    libs = list(libs)
    for lib in libs:
        lib.start()
    for lib in libs:
        lib.load()


__all__ = ["CudaLibrary", "build_all", "nvcc", "BUILD_DIR", "NVCC_FLAGS"]
