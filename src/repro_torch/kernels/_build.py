"""Build route shared by the port's CUDA kernels: ``nvcc`` + ``ctypes``.

Each source under ``src/repro_torch/csrc/`` is compiled at first use into a
shared library with a plain C interface, ``build/kernels/lib<stem>_<hash>.so``
at the repository root (listed in ``.gitignore``), keyed by the hash of the
source and the flags, and loaded with ``ctypes``.  This route includes no
PyTorch header, so a build takes seconds where
``torch.utils.cpp_extension.load`` takes minutes.  Every C entry point
returns ``cudaGetLastError()`` after its launch; the wrappers raise when it
is not 0.

:func:`build_all` starts one ``nvcc`` per source that is not built yet, all
at once, then loads every library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Callable, Optional

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): cannot build "
                           "the port's CUDA kernels")
    return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")


class Library:
    """One CUDA source and its loaded library.  ``bind`` sets the
    ``argtypes`` / ``restype`` of the C entry points on the loaded CDLL."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self.bind = bind
        self.build_log = ""     # nvcc's output of a build this process ran
        self._lib: Optional[ctypes.CDLL] = None
        self._proc = None

    def path(self) -> pathlib.Path:
        tag = hashlib.sha1(self.source.read_bytes()
                           + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source.stem}_{tag}.so"

    def _start(self) -> None:
        """Start ``nvcc`` in the background unless the library exists."""
        if self._lib is not None or self._proc is not None \
                or self.path().exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        self._proc = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)

    def load(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load the library."""
        if self._lib is not None:
            return self._lib
        self._start()
        so = self.path()
        if self._proc is not None:
            proc, tmp = self._proc
            self._proc = None
            self.build_log = proc.communicate()[0]
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed to build {self.source}:\n"
                                   f"{self.build_log}")
            os.replace(tmp, so)         # atomic: concurrent builds agree
        lib = ctypes.CDLL(str(so))
        self.bind(lib)
        self._lib = lib
        return lib


def build_all(libs) -> None:
    """Build every library of ``libs`` with one ``nvcc`` each, all started
    together, and load them."""
    for lib in libs:
        lib._start()
    for lib in libs:
        lib.load()
