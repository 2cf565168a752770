"""Plain PyTorch versions of the kernels (the correctness contracts).

Port of ``repro/kernels/ref.py``: the plain versions the CPU takes and
``chip_smoke.py`` holds each CUDA kernel against on the card.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..device import strict_fp32

__all__ = ["masked_l2_topk_ref", "decode_attention_ref", "BIG", "lowest_id_topk"]

BIG = 3.4e38  # stand-in for +inf that survives arithmetic


def lowest_id_topk(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries per row, equal values in ascending column
    order (``jax.lax.top_k``'s tie rule; ``torch.topk`` does not promise
    it).  Columns beyond the row width come back as (+inf, -1)."""
    vals, idx = torch.sort(d2, dim=1, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    short = k - vals.shape[1]
    if short > 0:
        b = d2.shape[0]
        vals = torch.cat([vals, d2.new_full((b, short), float("inf"))], 1)
        idx = torch.cat([idx, idx.new_full((b, short), -1)], 1)
    return vals, idx


def masked_l2_topk_ref(
    queries: torch.Tensor,  # (B, d) f32
    corpus: torch.Tensor,   # (N, d) f32
    mask: torch.Tensor,     # (N,) bool / {0,1}
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact masked top-k by squared L2.  Masked-out -> dist BIG, id -1."""
    strict_fp32()
    q2 = (queries * queries).sum(1, keepdim=True)
    x2 = (corpus * corpus).sum(1)
    d2 = torch.clamp_min(q2 + x2[None, :] - 2.0 * (queries @ corpus.T), 0.0)
    d2 = torch.where(mask.to(torch.bool)[None, :], d2, torch.full_like(d2, BIG))
    d, idx = lowest_id_topk(d2, k)
    empty = d >= BIG
    return d.masked_fill(empty, BIG), idx.masked_fill(empty, -1)


def decode_attention_ref(
    q: torch.Tensor,        # (B, KV, GQ, dh)  one new token, grouped heads
    k_cache: torch.Tensor,  # (B, KV_cache, S, dh)
    v_cache: torch.Tensor,  # (B, KV_cache, S, dh)
    length: torch.Tensor,   # (B,) valid KV length per sequence
    window=None,            # None (or >= S) = full attention
    attn_softcap: float = 0.0,
    k_scale=None,           # (B, KV_cache, S) f32 scales of int8 caches
    v_scale=None,
    dequant_dtype=torch.float32,
    kv0=None,               # the cache head of q's first KV head; None: every head
) -> torch.Tensor:
    """GQA decode attention over a (padded) KV cache; returns (B, KV, GQ, dh)
    f32.  The contract of the reference's ``decode_attention_xla``: scores
    scaled by dh**-0.5, then soft-capped (``cap * tanh(s / cap)`` when
    ``attn_softcap > 0``), then masked to the positions ``length - window <=
    p < length``, then softmax.  Computes in f32 whatever the cache type
    (bf16 is widened), as the kernel does; the reference oracle computes in
    q's type, which the wrapper makes f32.  int8 caches with scales are
    dequantized first (q * scale in f32, then cast to ``dequant_dtype``), as
    the reference's int8 decode does before its attention.  q's KV heads
    are the cache's ``kv0 .. kv0 + KV - 1`` (``kv0`` None: from 0; one
    rank's heads of a cache it holds whole), read as a view of it and
    widened (f32: copied) to a contiguous f32 tensor, so the result is
    bitwise that of the slice passed alone."""
    strict_fp32()
    kv0 = kv0 or 0
    heads = slice(kv0, kv0 + q.shape[1])
    k_cache, v_cache = k_cache[:, heads], v_cache[:, heads]
    if k_scale is not None:
        k_scale, v_scale = k_scale[:, heads], v_scale[:, heads]
    if k_scale is not None:
        k_cache = (k_cache.float() * k_scale[..., None]).to(dequant_dtype)
        v_cache = (v_cache.float() * v_scale[..., None]).to(dequant_dtype)
    q, k, v = q.float(), k_cache.float().contiguous(), v_cache.float().contiguous()
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bkgd,bksd->bkgs", q, k) * scale
    if attn_softcap > 0:
        scores = torch.tanh(scores / attn_softcap) * attn_softcap
    pos = torch.arange(k.shape[2], device=k.device)
    length = length.to(k.device)[:, None]
    valid = pos[None, :] < length
    if window is not None:
        valid &= pos[None, :] >= length - window
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, -BIG))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgs,bksd->bkgd", w, v)
