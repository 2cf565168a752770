"""Flash-decode GQA attention: the Hopper kernel and its loader.

Port of the Pallas kernel ``repro/kernels/decode_attention.py::_kernel``.
The kernel is CUDA C++ for ``sm_90a`` (``csrc/decode_attention.cu``), built
with ``nvcc`` at first use and bound with :mod:`ctypes` by the shared
loader in :mod:`.nvcc`: once for the f32 and bf16 caches and once, with
``-DDECODE_ATTENTION_INT8``, for int8 ones, two nvcc processes that run
side by side (:func:`build_library`, :func:`build_int8_library`).

What bounds it: the K/V bytes below each row's length (about 5 flop per
byte at qwen3-14b's GQ = 5 in bf16, far below the H100's ridge), so the
design is about bytes in flight per SM, idle SMs and each block's fixed
cost.  One launch per call:

* one block per (position chunk, kv head, row); a block past its row's
  length exits at once, the others write the chunk's fp32 partial
  (m, l, acc) and count in on a per-(row, kv head) counter; the last block
  of a row combines its partials in chunk order and writes ``out``; a row of
  one chunk writes ``out`` directly.  This replaced the first version's
  second launch, whose B*KV blocks walked every chunk serially (0.3703 ms
  against SDPA's 0.0618 ms at B=1, S=32768, bf16 [H100 80GB HBM3, 700 W]);
* K and V reach shared memory by ``cp.async.bulk`` copies into a ring of
  sub-tiles per warp, with an online softmax across sub-tiles, so the sweep
  has no block barrier (the first version read K, then V, behind six
  barriers); the q.k sums are reduced across lanes transposed, one exp per
  (row, head);
* the chunk size comes from :func:`chunk_positions` (S, dh and the element
  size, never B or the lengths), so a row is bitwise the same alone or in
  any batch; it leaves at least 17 chunks a row, enough blocks at B=1 to
  fill the card from S = 2088 on at qwen3's 8 kv heads, and no more than 64;
* per-head state at the exact group sizes 1, 2, 4, 5, 8, 16;
* a sliding window and a softcap (the reference's ``decode_attention_xla``
  contract, which gemma2's decode uses) are launch arguments, not template
  parameters: a row reads only the positions ``max(0, len - window) <= p <
  len``, so a chunk wholly below the window exits at once as one past the
  length does, and the arrival count and the combine span the live chunks
  only.  The chunk size does not depend on the window, so a row is bitwise
  the same alone or in any batch with a window too;
* nothing allocated per call but ``out``: the workspace (partials and
  counters) is cached per (device, stream, shape) and its counters are
  zeroed once, at creation; the kernel leaves them zero;
* int8 K/V with fp32 scales (B, KV, S), the int8 KV cache's layout
  (``decode_attention_int8``): dequantized in registers, each value q *
  scale rounded to ``dequant_dtype`` (bf16 or fp32, a launch argument) as
  the reference's ``dequantize_kv(...).astype(x.dtype)``; no dequantized
  cache is written, so a position costs dh + 4 bytes of K and of V.  It
  tiles as bf16 does (``TILE_ELEM``), and its scales arrive by 4-byte
  copies, since a window's first position need not leave them 16-byte
  aligned;
* one rank's KV heads of a cache it holds whole (tensor-parallel serving
  keeps the cache replicated over the model axis): ``kv0`` and the cache's
  own head count are launch arguments, q and ``out`` are the rank's (B,
  KV_local, GQ, dh), and the blocks address K/V and the scales as heads
  ``kv0 + h`` of the cache in place (no per-step copy of the slice, which
  is not contiguous at B > 1).  ``kv0 = 0`` over the whole cache is the
  launch it always was.

:func:`decode_attention_dispatch` is the one entry: tensors on the CPU take
the plain PyTorch version (:func:`repro_torch.kernels.ref.decode_attention_ref`);
tensors on a CUDA device launch the kernel or raise.  ``launches`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from pathlib import Path
from typing import Tuple

import torch

from .nvcc import CudaLibrary
from .ref import decode_attention_ref

__all__ = [
    "WARPS", "SUPPORTED_DH", "MAX_GQ", "SOURCE", "sub_tile_rows", "chunk_positions",
    "tile_elem", "window_positions",
    "workspace_numel", "workspace", "build_library", "build_int8_library", "launches",
    "reset_launches",
    "check_contract", "decode_attention_cuda", "decode_attention_dispatch",
]

# the kernel's tiling; the .cu file holds the same constants
WARPS = 4                     # warps per block, each with its own ring
STAGE_BYTES = 8192            # K + V bytes of one sub-tile
MIN_CHUNKS = 17               # chunks a row has at least, once S is over 16 passes
LONG_CHUNKS = 32              # chunks a long row aims at
MAX_PASSES = 16               # passes a chunk grows to before LONG_CHUNKS applies
SUPPORTED_DH = (32, 64, 128, 256)
MAX_GQ = 16
SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
WORKSPACES = 8                # cached workspaces, least recently used dropped

launches = 0                  # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def tile_elem(dtype: torch.dtype) -> int:
    """The element size the tiling follows: the cache's own, but int8 tiles
    as bf16 (8 values a lane, bf16's rows a sub-tile)."""
    return 2 if dtype == torch.int8 else torch.finfo(dtype).bits // 8


def sub_tile_rows(dh: int, elem: int) -> int:
    """Rows of K (and of V) in one sub-tile: STAGE_BYTES of K and V."""
    return STAGE_BYTES // (2 * dh * elem)


def chunk_positions(s: int, dh: int, elem: int) -> int:
    """Positions per block, in whole passes (one sub-tile per warp).  As
    many passes as leave at least MIN_CHUNKS chunks (17 x qwen3's 8 kv
    heads = 136 blocks >= the H100's 132 SMs at B=1), up to MAX_PASSES;
    past that, S / LONG_CHUNKS in whole passes, so a long row keeps about
    32 chunks to spread over the SMs (never more than 64).  Short caches get few, large chunks, each block's
    fixed cost (the copy's latency, the end-of-chunk reduction, the
    arrival) shared by more bytes; long ones get many.  Depends on the
    cache length S, the head width and the element size only, never on the
    batch or the lengths, so a row splits the same way alone and in any
    batch."""
    one_pass = WARPS * sub_tile_rows(dh, elem)
    few = (s - 1) // ((MIN_CHUNKS - 1) * one_pass)
    cap = max(MAX_PASSES, s // (LONG_CHUNKS * one_pass))
    return one_pass * max(1, min(few, cap))


def workspace_numel(b: int, kv: int, gq: int, dh: int, n_chunks: int) -> Tuple[int, int]:
    """(fp32 partials, int32 counters): m and l per (row, kv head, chunk,
    head), each padded to a multiple of 4 so that acc, per (row, kv head,
    chunk, head, column), starts 16-byte aligned (hymba's 5 x 5 heads make
    the count odd at an odd B and chunk count); one counter per (row, kv
    head)."""
    rows = b * kv * n_chunks * gq
    return 2 * (-(-rows // 4) * 4) + rows * dh, b * kv


_WORKSPACE: "OrderedDict[tuple, Tuple[torch.Tensor, torch.Tensor]]" = OrderedDict()


def workspace(device: torch.device, stream: int, b: int, kv: int, gq: int, dh: int,
              n_chunks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cached (partials, counters) for one shape on one stream.  The
    counters are zeroed here, once; the kernel leaves them zero.  Two calls
    running at once on different streams must not share a workspace, hence
    the stream in the key.  A dropped entry's memory goes back to PyTorch's
    stream-ordered allocator, so work still queued on the stream keeps it."""
    key = (device, stream, b, kv, gq, dh, n_chunks)
    ws = _WORKSPACE.get(key)
    if ws is None:
        n_part, n_count = workspace_numel(b, kv, gq, dh, n_chunks)
        ws = (torch.empty(n_part, dtype=torch.float32, device=device),
              torch.zeros(n_count, dtype=torch.int32, device=device))
        _WORKSPACE[key] = ws
        while len(_WORKSPACE) > WORKSPACES:
            _WORKSPACE.popitem(last=False)
    else:
        _WORKSPACE.move_to_end(key)
    return ws


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.decode_attention_f32, lib.decode_attention_bf16):
        fn.argtypes = [vp, vp, vp, vp] + [i32] * 10 + [f32, vp, vp, vp, vp]
        fn.restype = i32


def _bind_int8(lib: ctypes.CDLL) -> None:
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_int8.argtypes = [vp] * 6 + [i32] * 10 + [f32, i32] + [vp] * 4
    lib.decode_attention_int8.restype = i32


# the f32 and bf16 entries, and the int8 one: one source built twice, so
# the two halves of the instantiations compile side by side
_LIB = CudaLibrary(SOURCE, _bind)
_LIB_INT8 = CudaLibrary(SOURCE, _bind_int8, defines=("DECODE_ATTENTION_INT8",))
build_library = _LIB.build     # (verbose=False) -> path of the built library
build_int8_library = _LIB_INT8.build


def window_positions(window, s: int) -> int:
    """The window as the kernel takes it: ``None`` (full attention) or a
    window of at least S positions is S, which masks nothing."""
    return s if window is None or window >= s else int(window)


_CACHE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
_DEQUANT_DTYPES = (torch.float32, torch.bfloat16)


def check_contract(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                   length: torch.Tensor, window=None, attn_softcap: float = 0.0,
                   k_scale=None, v_scale=None, dequant_dtype=torch.float32,
                   kv0=None) -> None:
    """The shapes and types both the kernel and its plain version take;
    raises on any other.  (The plain version would compute any shape, but a
    caller that passes the CPU tests must also run on the card.)  q's KV
    heads are the cache's: all of them (``kv0`` None, caches (B, KV, S,
    dh)), or ``kv0 .. kv0 + KV - 1`` of caches (B, KV_cache, S, dh),
    KV_cache >= kv0 + KV.  Caches are both float32, both bfloat16, or
    both int8 with float32 ``k_scale`` and ``v_scale`` (B, KV_cache, S) and
    a ``dequant_dtype`` of float32 or bfloat16."""
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(f"q must be (B, KV, GQ, dh) and caches (B, KV, S, dh); got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, kv, gq, dh = q.shape
    kvc, s = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != (b, kvc, s, dh) or v_cache.shape != k_cache.shape
            or (kv0 is None and kvc != kv)):
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}, {tuple(v_cache.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if kv0 is not None and (int(kv0) != kv0 or kv0 < 0 or kv0 + kv > kvc):
        raise ValueError(f"q's {kv} KV heads from kv0={kv0!r} do not lie in the cache's {kvc}")
    if length.shape != (b,):
        raise ValueError(f"length must have shape ({b},), got {tuple(length.shape)}")
    if dh not in SUPPORTED_DH:
        raise ValueError(f"head dim {dh} not in {SUPPORTED_DH}")
    if not 1 <= gq <= MAX_GQ:
        raise ValueError(f"{gq} query heads per kv head; the kernel takes 1..{MAX_GQ}")
    if min(b, kv, s) < 1 or max(b, kv, s) >= 2**31:
        raise ValueError(f"unsupported shape B={b} KV={kv} S={s}")
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"window must be None or a whole number >= 1, got {window!r}")
    if not 0.0 <= attn_softcap < float("inf"):
        raise ValueError(f"attn_softcap must be finite and >= 0, got {attn_softcap!r}")
    if k_cache.dtype not in _CACHE_DTYPES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"caches must both be float32, bfloat16 or int8, got "
                        f"{k_cache.dtype} and {v_cache.dtype}")
    int8 = k_cache.dtype == torch.int8
    if int8 != (k_scale is not None) or int8 != (v_scale is not None):
        raise TypeError("int8 caches take k_scale and v_scale, and other caches take neither")
    if int8:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape != (b, kvc, s) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 of shape {(b, kvc, s)}, got "
                                 f"{t.dtype} {tuple(t.shape)}")
        if dequant_dtype not in _DEQUANT_DTYPES:
            raise TypeError(f"dequant_dtype must be float32 or bfloat16, got {dequant_dtype}")


def decode_attention_cuda(
    q: torch.Tensor,        # (B, KV, GQ, dh) f32
    k_cache: torch.Tensor,  # (B, KV_cache, S, dh) f32, bf16 or int8
    v_cache: torch.Tensor,  # (B, KV_cache, S, dh), k_cache's type
    length: torch.Tensor,   # (B,) int32, 1 <= length[b] <= S
    window=None,            # None = full attention
    attn_softcap: float = 0.0,
    k_scale=None,           # (B, KV_cache, S) f32, with int8 caches only
    v_scale=None,
    dequant_dtype=torch.float32,   # what an int8 value is rounded to after q * scale
    kv0=None,               # the cache head of q's first KV head; None: q has every head
) -> torch.Tensor:
    """Launch the kernel, once, on the current stream (no synchronisation);
    returns (B, KV, GQ, dh) f32 over the cache's heads ``kv0 .. kv0 + KV -
    1``, read in place.  Positions >= ``length[b]`` and below ``length[b] -
    window`` are never read (nor their scales), nor any other head.
    Allocates ``out`` and nothing else once the workspace for this shape and
    stream is cached."""
    global launches
    check_contract(q, k_cache, v_cache, length, window, attn_softcap, k_scale, v_scale,
                   dequant_dtype, kv0)
    dev = q.device
    int8 = k_cache.dtype == torch.int8
    tensors = (q, k_cache, v_cache, length) + ((k_scale, v_scale) if int8 else ())
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("decode_attention_cuda needs all tensors on one CUDA device")
    if q.dtype != torch.float32 or length.dtype != torch.int32:
        raise TypeError(f"decode_attention_cuda takes a float32 q and int32 lengths, got "
                        f"{q.dtype} and {length.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention_cuda needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (k_cache, v_cache)):
        raise ValueError("the caches must start on a 16-byte boundary")
    b, kv, gq, dh = q.shape
    kvc, s = k_cache.shape[1], k_cache.shape[2]
    lib = _LIB_INT8.get() if int8 else _LIB.get()
    chunk = chunk_positions(s, dh, tile_elem(k_cache.dtype))
    n_chunks = -(-s // chunk)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part, counters = workspace(dev, stream, b, kv, gq, dh, n_chunks)
    out = torch.empty((b, kv, gq, dh), dtype=torch.float32, device=dev)
    shape = (b, kv, kvc, int(kv0 or 0), s, gq, dh, chunk, n_chunks, window_positions(window, s),
             float(attn_softcap))
    tail = (part.data_ptr(), counters.data_ptr(), out.data_ptr(), stream)
    if int8:
        err = lib.decode_attention_int8(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), length.data_ptr(), *shape, int(dequant_dtype == torch.bfloat16),
            *tail)
    else:
        fn = (lib.decode_attention_bf16 if k_cache.dtype == torch.bfloat16
              else lib.decode_attention_f32)
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), length.data_ptr(),
                 *shape, *tail)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out


def decode_attention_dispatch(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, length: torch.Tensor,
    window=None, attn_softcap: float = 0.0, k_scale=None, v_scale=None,
    dequant_dtype=torch.float32, kv0=None,
) -> torch.Tensor:
    """CPU tensors -> the plain version; CUDA tensors -> the kernel.  Both
    take only the shapes and types :func:`check_contract` accepts."""
    args = (q, k_cache, v_cache, length, window, attn_softcap, k_scale, v_scale, dequant_dtype,
            kv0)
    if q.device.type == "cpu":
        check_contract(*args)
        return decode_attention_ref(*args)
    if q.device.type == "cuda":
        return decode_attention_cuda(*args)
    raise ValueError(f"no decode_attention for device {q.device}")
