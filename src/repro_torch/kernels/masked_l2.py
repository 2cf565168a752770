"""Fused masked-L2-distance + exact top-k: the Hopper kernel and its loader.

Port of the Pallas kernel ``repro/kernels/masked_l2.py::_kernel``.  The
kernel is CUDA C++ for ``sm_90a`` (``csrc/masked_l2_topk.cu``): it is built
with ``nvcc`` into a shared library with a plain C interface at first use,
into ``BUILD_DIR`` (git-ignored), and bound with :mod:`ctypes`.  The source
explains the design and its bound on the card.

:func:`masked_l2_topk_dispatch` is the one entry: tensors on the CPU take
the plain PyTorch version (:func:`repro_torch.kernels.ref.masked_l2_topk_ref`);
tensors on a CUDA device launch the kernel or raise.  ``launches`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import torch

from .ref import BIG, masked_l2_topk_ref

__all__ = [
    "KPAD", "BIG", "BUILD_DIR", "SOURCE", "build_library", "launches",
    "reset_launches", "masked_l2_topk_cuda", "masked_l2_topk_dispatch",
    "query_tile", "split_plan",
]

KPAD = 128            # largest k the kernel's per-query lists hold
TN = 256              # corpus rows per tile (must match the .cu)
BLOCKS_PER_SM = 4     # resident pass-1 blocks per SM the split count aims at
MAX_D = 4096          # query tile staged in shared memory: (d, 8) f32
SOURCE = Path(__file__).resolve().parent / "csrc" / "masked_l2_topk.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

launches = 0          # kernel launches since the last reset_launches()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    global launches
    launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the masked_l2_topk kernel cannot be built")


def build_library(verbose: bool = False) -> Path:
    """Compile ``SOURCE`` into ``BUILD_DIR`` unless a library built from the
    same source bytes is already there; returns the library's path.  The
    file name carries the source hash, and the build lands under a temporary
    name first, so concurrent builders never load a half-written file."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libmasked_l2_topk_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        if verbose:
            print(proc.stderr.strip())
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.masked_l2_topk_f32.argtypes = [
            vp, vp, vp, i32, i64, i32, i32, i32, i32, i64, vp, vp, vp, vp,
            ctypes.c_float, vp,
        ]
        lib.masked_l2_topk_f32.restype = i32
        _lib = lib
    return _lib


def query_tile(b: int) -> int:
    """Queries per pass-1 block: 1 for a single query (no FMAs spent on
    empty tile slots), else 8."""
    return 1 if b == 1 else 8


def split_plan(b: int, n: int, n_sms: int) -> Tuple[int, int]:
    """``(splits, rows_per_split)`` of the corpus axis: enough pass-1 blocks
    to fill ``BLOCKS_PER_SM`` per SM, each split a whole number of tiles."""
    tiles = max(1, -(-n // TN))
    qtiles = -(-b // query_tile(b))
    want = max(1, -(-(BLOCKS_PER_SM * n_sms) // qtiles))
    per = -(-tiles // min(tiles, want))
    return -(-tiles // per), per * TN


def masked_l2_topk_cuda(
    queries: torch.Tensor, corpus: torch.Tensor, mask: torch.Tensor, k: int,
    empty: float = BIG,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream (no synchronisation).

    queries (B, d) f32, corpus (N, d) f32, mask (N,) bool, all contiguous on
    one CUDA device; 1 <= k <= KPAD.  Returns (dists (B, k) f32, ids (B, k)
    i32), slots with no passing row as (``empty``, -1)."""
    global launches
    b, d = queries.shape
    n = corpus.shape[0]
    dev = queries.device
    if dev.type != "cuda" or corpus.device != dev or mask.device != dev:
        raise ValueError("masked_l2_topk_cuda needs all tensors on one CUDA device")
    if queries.dtype != torch.float32 or corpus.dtype != torch.float32:
        raise TypeError("masked_l2_topk_cuda takes float32 queries and corpus")
    if mask.dtype != torch.bool or mask.shape != (n,):
        raise TypeError(f"mask must be bool of shape ({n},), got {mask.dtype} {tuple(mask.shape)}")
    if corpus.shape[1] != d or not 1 <= d <= MAX_D:
        raise ValueError(f"bad widths: queries d={d}, corpus d={corpus.shape[1]}")
    if not 1 <= k <= KPAD:
        raise ValueError(f"k={k} outside [1, {KPAD}]")
    if n >= 2**31 or b < 1:
        raise ValueError(f"unsupported shape B={b}, N={n}")
    if not (queries.is_contiguous() and corpus.is_contiguous() and mask.is_contiguous()):
        raise ValueError("masked_l2_topk_cuda needs contiguous tensors")
    lib = _library()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, rows = split_plan(b, n, n_sms)
    part_d = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.masked_l2_topk_f32(
        queries.data_ptr(), corpus.data_ptr(), mask.data_ptr(), b, n, d, k,
        query_tile(b), splits, rows, part_d.data_ptr(), part_i.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), float(empty), stream,
    )
    if err != 0:
        raise RuntimeError(f"masked_l2_topk kernel launch failed: cudaError {err}")
    launches += 1
    return out_d, out_i


def masked_l2_topk_dispatch(
    queries: torch.Tensor, corpus: torch.Tensor, mask: torch.Tensor, k: int,
    empty: float = BIG,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CPU tensors -> the plain version; CUDA tensors -> the kernel."""
    if queries.device.type == "cpu":
        d, i = masked_l2_topk_ref(queries, corpus, mask, k)
        if empty != BIG:
            d = torch.where(i < 0, torch.full_like(d, empty), d)
        return d, i
    if queries.device.type == "cuda":
        return masked_l2_topk_cuda(queries, corpus, mask, k, empty)
    raise ValueError(f"no masked_l2_topk for device {queries.device}")
