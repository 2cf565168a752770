"""Fused masked-L2-distance + exact top-k: the Hopper kernel and its loader.

Port of the Pallas kernel ``repro/kernels/masked_l2.py::_kernel``.  The
kernel is CUDA C++ for ``sm_90a`` (``csrc/masked_l2_topk.cu``): it is built
with ``nvcc`` into a shared library with a plain C interface at first use,
into ``BUILD_DIR`` (git-ignored), and bound with :mod:`ctypes`, by the
shared loader in :mod:`.nvcc`.  The source explains the design and its
bound on the card.

:func:`masked_l2_topk_dispatch` is the one entry: tensors on the CPU take
the plain PyTorch version (:func:`repro_torch.kernels.ref.masked_l2_topk_ref`);
tensors on a CUDA device launch the kernel or raise.  ``launches`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from .nvcc import BUILD_DIR, CudaLibrary
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

launches = 0          # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.masked_l2_topk_f32.argtypes = [
        vp, vp, vp, i32, i64, i32, i32, i32, i32, i64, vp, vp, vp, vp,
        ctypes.c_float, vp,
    ]
    lib.masked_l2_topk_f32.restype = i32


_LIB = CudaLibrary(SOURCE, _bind)
build_library = _LIB.build     # (verbose=False) -> path of the built library


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
    lib = _LIB.get()
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
