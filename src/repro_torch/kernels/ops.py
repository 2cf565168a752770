"""Public wrappers around the kernels, and the dispatch ledger.

Port of ``repro/kernels/ops.py``.  Tensors on the CPU run the kernels' plain
versions; tensors on a CUDA device launch the hand-written kernels (or
raise): ``masked_l2_topk`` / ``fused_masked_topk`` for the filtered-ANN
scans, ``decode_attention`` for the LM's decode step.
"""
from __future__ import annotations

import time
from typing import Dict, Tuple

import torch

from . import decode_attention as _decode_attention
from . import masked_l2
from .decode_attention import decode_attention_dispatch
from .masked_l2 import KPAD, masked_l2_topk_dispatch

__all__ = [
    "masked_l2_topk", "fused_masked_topk", "decode_attention", "KPAD",
    "record_dispatch", "dispatch_counts", "dispatch_wall",
    "reset_dispatch_stats", "kernel_launches", "reset_kernel_launches",
]

# ----------------------------------------------------------------------
# process-global dispatch ledger, as in the reference: one count and the
# dispatch-call wall seconds per named route.  Device work is asynchronous,
# so the wall is the enqueue time; results reach the host at the caller.
# ----------------------------------------------------------------------
_DISPATCH_COUNTS: Dict[str, int] = {}
_DISPATCH_WALL: Dict[str, float] = {}


def record_dispatch(name: str, seconds: float = 0.0) -> None:
    _DISPATCH_COUNTS[name] = _DISPATCH_COUNTS.get(name, 0) + 1
    _DISPATCH_WALL[name] = _DISPATCH_WALL.get(name, 0.0) + float(seconds)


def dispatch_counts() -> Dict[str, int]:
    return {k: _DISPATCH_COUNTS[k] for k in sorted(_DISPATCH_COUNTS)}


def dispatch_wall() -> Dict[str, float]:
    return {k: _DISPATCH_WALL[k] for k in sorted(_DISPATCH_WALL)}


def reset_dispatch_stats() -> None:
    _DISPATCH_COUNTS.clear()
    _DISPATCH_WALL.clear()


def kernel_launches() -> Dict[str, int]:
    """Launches of each hand-written kernel since the last reset."""
    return {"masked_l2_topk": masked_l2.launches,
            "decode_attention": _decode_attention.launches}


def reset_kernel_launches() -> None:
    masked_l2.reset_launches()
    _decode_attention.reset_launches()


def _prep(queries: torch.Tensor, corpus: torch.Tensor, mask: torch.Tensor):
    return (queries.to(torch.float32).contiguous(),
            corpus.to(torch.float32).contiguous(),
            mask.to(torch.bool).contiguous())


def masked_l2_topk(
    queries: torch.Tensor,  # (B, d)
    corpus: torch.Tensor,   # (N, d)
    mask: torch.Tensor,     # (N,) bool
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused masked brute-force top-k.  Matches ``masked_l2_topk_ref``:
    masked-out or short slots are (BIG, -1)."""
    if not 1 <= k <= KPAD:
        raise ValueError(f"k={k} exceeds kernel buffer {KPAD}")
    return masked_l2_topk_dispatch(*_prep(queries, corpus, mask), k)


def fused_masked_topk(
    queries: torch.Tensor,  # (B, d)
    corpus: torch.Tensor,   # (N, d)
    mask: torch.Tensor,     # (N,) bool
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serving-path entry for the fused masked brute-force top-k:
    (dists (B, k), ids (B, k)), masked-out or short slots (+inf, -1).

    k <= KPAD runs the kernel (its plain version on the CPU) and records
    ``fused_masked_topk``.  k > KPAD is beyond the kernel's lists and runs
    ``index.flat.l2_topk``, as the reference does, recorded under its own
    name ``fused_masked_topk_l2_topk``.
    """
    t0 = time.perf_counter()
    q, x, m = _prep(queries, corpus, mask)
    if k <= KPAD:
        out = masked_l2_topk_dispatch(q, x, m, k, empty=float("inf"))
        record_dispatch("fused_masked_topk", time.perf_counter() - t0)
    else:
        from ..index.flat import l2_topk

        out = l2_topk(q, x, k, m)
        record_dispatch("fused_masked_topk_l2_topk", time.perf_counter() - t0)
    return out


def decode_attention(
    q: torch.Tensor,        # (B, KV, GQ, dh)
    k_cache: torch.Tensor,  # (B, KV, S, dh) f32 or bf16
    v_cache: torch.Tensor,  # (B, KV, S, dh)
    length: torch.Tensor,   # (B,) valid positions, 1 <= length[b] <= S
) -> torch.Tensor:
    """Flash-decode GQA attention; matches ``decode_attention_ref`` and
    returns (B, KV, GQ, dh) f32.  q is cast to f32; the caches are taken as
    they are (f32 or bf16) and are not padded: the kernel stops at each
    row's length and never reads the ragged tail."""
    t0 = time.perf_counter()
    out = decode_attention_dispatch(q.to(torch.float32).contiguous(), k_cache, v_cache,
                                    length.to(torch.int32).contiguous())
    record_dispatch("decode_attention", time.perf_counter() - t0)
    return out
