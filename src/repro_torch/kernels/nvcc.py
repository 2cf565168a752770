"""Build a kernel's CUDA source with ``nvcc`` and bind it with :mod:`ctypes`.

Every hand-written kernel of the port is one ``csrc/<name>.cu`` file with a
plain C interface.  At first use it is compiled for ``sm_90a`` into a shared
library under ``BUILD_DIR`` (git-ignored), named after the source and a hash
of its bytes and flags, and loaded with :class:`ctypes.CDLL`.  A source may
be built more than once with other ``-D`` defines (the decode kernel's int8
variant), so that its parts compile as separate nvcc processes side by
side.  Nothing here
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
from typing import Callable, Optional, Tuple

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_library", "CudaLibrary"]

BUILD_DIR = Path(__file__).resolve().parent / "_build"
# --split-compile=0 optimises a source's kernels in parallel on every core
# (the decode kernel's 64 instantiations build in ~35 s instead of ~90 s)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--split-compile=0", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def build_library(source: Path, verbose: bool = False, defines: Tuple[str, ...] = ()) -> Path:
    """Compile ``source`` (with ``-D`` for each of ``defines``) into
    ``BUILD_DIR`` unless a library built from the same source bytes and
    flags is already there; returns the library's path.  The file name
    carries the defines and a hash of source and flags, and the build lands
    under a temporary name first, so concurrent builders never load a
    half-written file."""
    source = Path(source)
    src = source.read_bytes()
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    name = "".join(f"_{d.lower()}" for d in defines)
    out = BUILD_DIR / f"lib{source.stem}{name}_{tag}.so"
    if out.exists():
        return out
    compiler = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, *(("-Xptxas", "-v") if verbose else ()),
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
    """One kernel source, built with ``defines``: built at first
    :meth:`get`, then loaded once and given its ``argtypes``/``restype``
    by ``bind``."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None],
                 defines: Tuple[str, ...] = ()):
        self.source = Path(source)
        self._bind = bind
        self.defines = tuple(defines)
        self._lib: Optional[ctypes.CDLL] = None

    def build(self, verbose: bool = False) -> Path:
        return build_library(self.source, verbose, self.defines)

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            self._lib = lib
        return self._lib
