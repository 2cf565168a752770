"""Fused masked-L2-distance + exact top-k: the Hopper kernel and its loader.

Port of the Pallas kernel ``repro/kernels/masked_l2.py::_kernel`` (launched
by ``masked_l2_topk_kernel``).  The kernel is CUDA C++ for ``sm_90a``
(``csrc/masked_l2_topk.cu``): it is built with ``nvcc`` into a shared
library with a plain C interface at first use, into ``BUILD_DIR``
(git-ignored), and bound with :mod:`ctypes`, by the shared loader in
:mod:`.nvcc`.

On an H100 the function is bound by bytes at B = 1 and 8 (each passing row
is read once for 2 B d flop) and by fp32 operations from B ~ 64.  So it
has two paths, and :func:`plan` picks one from (B, N, d, k) and the SM
count only, never from the data:

* **streaming** (B < ``TILED_MIN_B`` or N < ``TILED_MIN_N``): each thread
  streams one corpus row from device memory against 1 or 8 queries held in
  shared memory, and every row goes through a per-warp top-k list;
* **tiled** (otherwise): a block keeps 64 (or 32) queries in
  shared memory, stages tiles of 256 passing rows (compacted from the mask
  inside the kernel) in 32-column chunks with ``cp.async``, accumulates a
  4 x 8 register micro-tile per thread, and keeps only the candidates that
  beat each query's current k-th key (a shared-memory buffer merged into
  the sorted list).

A (query, row) distance is the same fp32 bits on both paths, so a row's
answer does not depend on the batch.  The previous single design took 6.8201
and 32.4572 ms at B = 64 and 256 over 2.14M rows, half passing, where the
port's ``l2_topk`` took 9.8893 and 28.2170 [H100 80GB HBM3, 700.00 W;
``chip_smoke.py`` phase 3]; the tiled path's times are in ``PERF.md``.
The source explains the design.

:func:`masked_l2_topk_dispatch` is the one entry: tensors on the CPU take
the plain PyTorch version (:func:`repro_torch.kernels.ref.masked_l2_topk_ref`);
tensors on a CUDA device launch the kernel or raise.  ``launches`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import torch

from .nvcc import BUILD_DIR, CudaLibrary
from .ref import BIG, masked_l2_topk_ref

__all__ = [
    "KPAD", "BIG", "BUILD_DIR", "SOURCE", "Plan", "build_library", "launches",
    "load_library",
    "reset_launches", "masked_l2_topk_cuda", "masked_l2_topk_dispatch",
    "plan", "query_tile", "smem_bytes", "split_plan",
]

KPAD = 128            # largest k the kernel's per-query lists hold
TN = 256              # split granularity: the streaming path's rows per tile
BLOCKS_PER_SM = 4     # resident streaming blocks per SM the split count aims at
MAX_D = 4096          # streaming query tile staged in shared memory: (d, 8) f32
SMEM_MAX = 232_448    # dynamic shared memory a block may use on sm_90 (227 KB)
# the tiled path (constants mirrored from the .cu)
TILED_MIN_B = 9       # the tiled path takes B >= TILED_MIN_B over N >= TILED_MIN_N
TILED_MIN_N = 16_384  # (below, a tiled block's fixed cost, a full tile of FMAs, loses)
TILED_QT = (64, 32)   # query tiles, widest first
TTHREADS, QG, MR, KC, STAGES, CAND = 512, 16, 8, 32, 2, 64
TT = TTHREADS // QG * MR            # passing rows per tile
XS, RING, TWARPS = KC + 4, 2 * TTHREADS, TTHREADS // 32
WARPS = 8                           # streaming path: warps a block
CPU_BLOCK, CPU_ROWS = 8, 1024   # queries x corpus rows per plain-version call on the CPU
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
    lib.masked_l2_topk_smem.argtypes = [i32, i32, i32]
    lib.masked_l2_topk_smem.restype = i64


_LIB = CudaLibrary(SOURCE, _bind)
build_library = _LIB.build     # (verbose=False) -> path of the built library
load_library = _LIB.get        # () -> the bound ctypes library, built at first use


def query_tile(b: int) -> int:
    """Queries per block on the streaming path: 1 for a single query (no
    FMAs spent on empty tile slots), else 8."""
    return 1 if b == 1 else 8


def smem_bytes(qt: int, d: int, k: int) -> int:
    """Pass 1's dynamic shared memory (``masked_l2_topk_smem`` in the .cu).
    Streaming (qt 1, 8): the query tile, |q|^2 and a list per warp and
    query.  Tiled (qt 32, 64): the chunk ring, the query tile, |q|^2 and
    |x|^2, a list and a candidate buffer per query, the row-id queue."""
    if qt in TILED_QT:
        words = (STAGES * TT * XS + d * qt + qt + TT + 2 * qt * k + 2 * qt * CAND + qt
                 + 2 * TT + RING + TWARPS + 2)
        return 4 * words
    return 4 * (d * qt + qt) + 8 * WARPS * qt * k


def split_plan(b: int, n: int, n_sms: int, qt: Optional[int] = None,
               blocks_per_sm: int = BLOCKS_PER_SM) -> Tuple[int, int]:
    """``(splits, rows_per_split)`` of the corpus axis: enough pass-1 blocks
    of ``qt`` queries (the streaming tile by default) to put up to
    ``blocks_per_sm`` on every SM, each split a whole number of ``TN`` rows."""
    tiles = max(1, -(-n // TN))
    qtiles = -(-b // (qt or query_tile(b)))
    want = max(1, blocks_per_sm * n_sms // qtiles)   # at most one wave
    per = -(-tiles // min(tiles, want))
    return -(-tiles // per), per * TN


@dataclasses.dataclass(frozen=True)
class Plan:
    path: str             # "streaming" or "tiled"
    qt: int               # queries per pass-1 block
    splits: int           # corpus splits (pass-1 grid is query tiles x splits)
    rows_per_split: int
    smem: int             # pass 1's dynamic shared memory, bytes


def plan(b: int, n: int, d: int, k: int, n_sms: int, aligned: bool = True) -> Plan:
    """The launch for a (B, d) x (N, d) call with lists of k: a function of
    these and the SM count only, never of the data.

    The tiled path takes B >= ``TILED_MIN_B`` over N >= ``TILED_MIN_N``
    rows when its needs hold (d % 4 == 0 and a 16-byte aligned corpus:
    ``aligned``) and one of its query tiles fits in shared memory: 64
    queries from B >= 64, else 32.  It runs one block per SM.  Everything
    else streams, 4 blocks per SM."""
    if (b >= TILED_MIN_B and n >= TILED_MIN_N and aligned and d % 4 == 0
            and -(-d // KC) >= STAGES - 1):
        for qt in TILED_QT:
            smem = smem_bytes(qt, d, k)
            if (qt <= b or qt == TILED_QT[-1]) and smem <= SMEM_MAX:
                return Plan("tiled", qt, *split_plan(b, n, n_sms, qt, 1), smem)
    qt = query_tile(b)
    return Plan("streaming", qt, *split_plan(b, n, n_sms, qt), smem_bytes(qt, d, k))


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
    lib = load_library()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = plan(b, n, d, k, n_sms, aligned=corpus.data_ptr() % 16 == 0)
    part_d = torch.empty((b, p.splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, p.splits, k), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.masked_l2_topk_f32(
        queries.data_ptr(), corpus.data_ptr(), mask.data_ptr(), b, n, d, k,
        p.qt, p.splits, p.rows_per_split, part_d.data_ptr(), part_i.data_ptr(),
        out_d.data_ptr(), out_i.data_ptr(), float(empty), stream,
    )
    if err != 0:
        raise RuntimeError(f"masked_l2_topk kernel launch failed: cudaError {err}")
    launches += 1
    return out_d, out_i


def _plain_blocked(queries, corpus, mask, k):
    b, dim = queries.shape
    n = corpus.shape[0]
    n_blk = max(1, -(-n // CPU_ROWS))
    pad = n_blk * CPU_ROWS - n
    x = torch.nn.functional.pad(corpus, (0, 0, 0, pad))
    m = torch.nn.functional.pad(mask.to(torch.bool), (0, pad), value=False)
    kb = min(k, CPU_ROWS)
    qb = queries.new_zeros((CPU_BLOCK, dim))
    out_d, out_i = [], []
    for s in range(0, b, CPU_BLOCK):
        e = min(b, s + CPU_BLOCK)
        qb.zero_()
        qb[: e - s] = queries[s:e]
        parts = [masked_l2_topk_ref(qb, x[r : r + CPU_ROWS], m[r : r + CPU_ROWS], kb)
                 for r in range(0, n_blk * CPU_ROWS, CPU_ROWS)]
        cat_d = torch.cat([p[0] for p in parts], 1)
        cat_i = torch.cat([torch.where(p[1] >= 0, p[1] + j * CPU_ROWS, -1)
                           for j, p in enumerate(parts)], 1)
        # stable: equal distances stay in row order (blocks ascend, and each
        # block's list is in (distance, id) order)
        vals, pos = torch.sort(cat_d, dim=1, stable=True)
        out_d.append(vals[: e - s, :k])
        out_i.append(torch.gather(cat_i, 1, pos)[: e - s, :k].to(torch.int32))
    if not out_d:
        return queries.new_zeros((0, k)), torch.zeros((0, k), dtype=torch.int32)
    return torch.cat(out_d), torch.cat(out_i)


def masked_l2_topk_dispatch(
    queries: torch.Tensor, corpus: torch.Tensor, mask: torch.Tensor, k: int,
    empty: float = BIG,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CPU tensors -> the plain version; CUDA tensors -> the kernel.

    On the CPU the plain version runs over fixed blocks of ``CPU_BLOCK``
    queries (zero-padded) by ``CPU_ROWS`` corpus rows (masked padding), and
    the blocks' lists merge in row order: BLAS rounds a product differently
    at other shapes, and a (query, row) distance must not depend on the
    batch, the corpus size or the row's position, as the kernel's do not."""
    if queries.device.type == "cpu":
        d, i = _plain_blocked(queries, corpus, mask, k)
        if empty != BIG:
            d = torch.where(i < 0, torch.full_like(d, empty), d)
        return d, i
    if queries.device.type == "cuda":
        return masked_l2_topk_cuda(queries, corpus, mask, k, empty)
    raise ValueError(f"no masked_l2_topk for device {queries.device}")
