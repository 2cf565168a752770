"""Build a kernel's CUDA source with ``nvcc`` and bind it with :mod:`ctypes`.

Every hand-written kernel of the port is one ``csrc/<name>.cu`` file with a
plain C interface.  At first use it is compiled for ``sm_90a`` into a shared
library under ``BUILD_DIR`` (git-ignored), named after the source and a hash
of its bytes and flags, and loaded with :class:`ctypes.CDLL`.  Nothing here
runs at import time, so the package imports on machines without CUDA.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Optional

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_library", "CudaLibrary"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build_library(source: Path, verbose: bool = False) -> Path:
    """Compile ``source`` into ``BUILD_DIR`` unless a library built from the
    same source bytes is already there; returns the library's path.  The
    file name carries the source hash, and the build lands under a temporary
    name first, so concurrent builders never load a half-written file."""
    source = Path(source)
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if out.exists():
        return out
    compiler = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                               f"{proc.stderr}")
        if verbose:
            print(proc.stderr.strip())
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


class CudaLibrary:
    """One kernel source: built at first :meth:`get`, then loaded once and
    given its ``argtypes``/``restype`` by ``bind``."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None

    def build(self, verbose: bool = False) -> Path:
        return build_library(self.source, verbose)

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            self._lib = lib
        return self._lib
