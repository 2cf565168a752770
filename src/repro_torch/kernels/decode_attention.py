"""Flash-decode GQA attention: the Hopper kernel and its loader.

Port of the Pallas kernel ``repro/kernels/decode_attention.py::_kernel``.
The kernel is CUDA C++ for ``sm_90a`` (``csrc/decode_attention.cu``), built
with ``nvcc`` at first use and bound with :mod:`ctypes` by the shared
loader in :mod:`.nvcc`.  The source explains the design (fixed position
chunks in parallel, then an in-order combine) and its bound on the card.

:func:`decode_attention_dispatch` is the one entry: tensors on the CPU take
the plain PyTorch version (:func:`repro_torch.kernels.ref.decode_attention_ref`);
tensors on a CUDA device launch the kernel or raise.  ``launches`` counts
kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .nvcc import CudaLibrary
from .ref import decode_attention_ref

__all__ = [
    "CHUNK", "SUPPORTED_DH", "MAX_GQ", "SOURCE", "build_library", "launches",
    "reset_launches", "check_contract", "decode_attention_cuda", "decode_attention_dispatch",
]

CHUNK = 256                   # positions per pass-1 block (must match the .cu)
SUPPORTED_DH = (32, 64, 128, 256)
MAX_GQ = 16
SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"

launches = 0                  # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.decode_attention_f32, lib.decode_attention_bf16):
        fn.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp, vp, vp, vp, vp]
        fn.restype = i32


_LIB = CudaLibrary(SOURCE, _bind)
build_library = _LIB.build     # (verbose=False) -> path of the built library


def check_contract(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                   length: torch.Tensor) -> None:
    """The shapes both the kernel and its plain version take; raises on any
    other.  (The plain version would compute any shape, but a caller that
    passes the CPU tests must also run on the card.)"""
    if q.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(f"q must be (B, KV, GQ, dh) and caches (B, KV, S, dh); got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, kv, gq, dh = q.shape
    s = k_cache.shape[2]
    if k_cache.shape != (b, kv, s, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}, {tuple(v_cache.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if length.shape != (b,):
        raise ValueError(f"length must have shape ({b},), got {tuple(length.shape)}")
    if dh not in SUPPORTED_DH:
        raise ValueError(f"head dim {dh} not in {SUPPORTED_DH}")
    if not 1 <= gq <= MAX_GQ:
        raise ValueError(f"{gq} query heads per kv head; the kernel takes 1..{MAX_GQ}")
    if min(b, kv, s) < 1 or max(b, kv, s) >= 2**31:
        raise ValueError(f"unsupported shape B={b} KV={kv} S={s}")


def decode_attention_cuda(
    q: torch.Tensor,        # (B, KV, GQ, dh) f32
    k_cache: torch.Tensor,  # (B, KV, S, dh) f32 or bf16
    v_cache: torch.Tensor,  # (B, KV, S, dh), k_cache's type
    length: torch.Tensor,   # (B,) int32, 1 <= length[b] <= S
) -> torch.Tensor:
    """Launch the kernel on the current stream (no synchronisation); returns
    (B, KV, GQ, dh) f32.  Positions >= ``length[b]`` are never read."""
    global launches
    check_contract(q, k_cache, v_cache, length)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k_cache, v_cache, length)):
        raise ValueError("decode_attention_cuda needs all tensors on one CUDA device")
    if q.dtype != torch.float32 or length.dtype != torch.int32:
        raise TypeError(f"decode_attention_cuda takes a float32 q and int32 lengths, got "
                        f"{q.dtype} and {length.dtype}")
    if k_cache.dtype not in (torch.float32, torch.bfloat16) or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"caches must both be float32 or bfloat16, got "
                        f"{k_cache.dtype} and {v_cache.dtype}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, length)):
        raise ValueError("decode_attention_cuda needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (k_cache, v_cache)):
        raise ValueError("the caches must start on a 16-byte boundary")
    b, kv, gq, dh = q.shape
    s = k_cache.shape[2]
    lib = _LIB.get()
    n_chunks = -(-s // CHUNK)
    part_m = torch.empty((b, kv, n_chunks, gq), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, kv, n_chunks, gq, dh), dtype=torch.float32, device=dev)
    out = torch.empty((b, kv, gq, dh), dtype=torch.float32, device=dev)
    fn = lib.decode_attention_bf16 if k_cache.dtype == torch.bfloat16 else lib.decode_attention_f32
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), length.data_ptr(),
             b, kv, s, gq, dh, n_chunks, part_m.data_ptr(), part_l.data_ptr(),
             part_acc.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out


def decode_attention_dispatch(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, length: torch.Tensor,
) -> torch.Tensor:
    """CPU tensors -> the plain version; CUDA tensors -> the kernel.  Both
    take only the shapes :func:`check_contract` accepts."""
    if q.device.type == "cpu":
        check_contract(q, k_cache, v_cache, length)
        return decode_attention_ref(q, k_cache, v_cache, length)
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k_cache, v_cache, length)
    raise ValueError(f"no decode_attention for device {q.device}")
